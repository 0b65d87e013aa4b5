// Flash-attention backward for decoder-LM training, hand-written for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention_bwd
// (_bwd_kv_kernel, pallas_call at :224, and _bwd_q_kernel, pallas_call at
// :246).  FlashAttention-2 backward from the forward's saved log-sum-exp:
// q/do [B, S, Hq, hd], k/v [B, T, Hkv, hd] with native GQA (q head h reads
// kv head h / (Hq / Hkv)), lse and delta = rowsum(dO * O) [B, Hq, S] in
// float32, returning dq [B, S, Hq, hd] and dk/dv [B, T, Hkv, hd] in the
// input dtype.  The arithmetic is the TPU kernels': scores (q . k) * hd^-0.5
// in float32, the causal mask (k <= q) and the window (k > q - window),
// p = exp(s - lse) on unmasked pairs and 0 elsewhere, dv += p^T dO,
// dp = dO v^T, ds = p (dp - delta) * scale, dk += ds^T q, dq += ds k, all
// accumulated in float32 and cast once at the end.
//
// What bounds it on this card: operations.  At Llama-3.2-3B's training
// shape (B = 1, S = 2048, 24 q heads, hd = 128, causal) the backward needs
// five products of 2 * hd flop per unmasked pair (s, dp, dv, dk, dq):
// 64.5 GFLOP against 67 MB of operands, ~960 flop per byte, above the
// card's ~295 in bf16.  The two kernels do seven (each recomputes s and
// dp).
//
// Both routes keep the TPU's split into a dK/dV kernel and a dQ kernel, so
// no atomics and the same gradients run to run.  The dK/dV kernel takes one
// block per (64-key tile, kv head, batch) and loops over the G q heads of
// its group and the q tiles holding an unmasked pair (causal: from the
// diagonal on; window: up to the tile's last key + window), so GQA is
// summed in registers, where the TPU version expands k/v to Hq heads and
// group-sums a [B, Hq, T, hd] float32 buffer afterwards; the dQ kernel one
// block per (64-row q tile, q head, batch) looping over kv tiles.  Key
// tiles go in ascending order (the first meets every q tile), q tiles in
// descending order (heaviest first); rows and keys past S and T load as
// zeros and are masked (the TPU kernels drop a ragged tail).  The C entry
// chooses the route by its dtype argument (a route by type, not a fallback):
//
// dtype 0, float32: CUDA cores in full float32, the first version of these
// kernels; delta comes from the caller.
// - operands staged in shared memory as float32, each in the layout its
//   products read: transposed ([hd][64 + 4]) where a thread reads 4 rows at
//   once, row-major with an odd stride (hd + 1) where 16 lanes read 16 rows;
// - thread (ty, tx) of a 16 x 16 grid owns 4 "own" rows (keys in dK/dV,
//   q rows in dQ) and 4 "other" rows of each 64 x 64 score tile and output
//   columns tx, tx+16, ..., every accumulator in registers;
// - p and ds go through shared memory for the second-stage products;
//   171,008 bytes (dK/dV) and 153,088 bytes (dQ) at hd = 128, one block per
//   SM.
//
// dtype 1, bfloat16: tensor cores, mma.sync.m16n8k16 for all five products
// (namespace tc below).  delta = rowsum(dO * O) is computed first by a small
// kernel here, from the bf16 dO and O in float32, into the caller's buffer.
// - 128-thread blocks; warp w owns 16 rows that are the products' M: keys
//   in dK/dV (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q), q
//   rows in dQ (S = Q K^T, dP = dO V^T, dQ += dS K);
// - operand tiles come in by cp.async, double-buffered, as bf16 in shared
//   memory with the 16-byte chunks of each row XOR-swizzled by the row, and
//   products read them with ldmatrix (.trans where the product needs the
//   other orientation: dO and Q in dK/dV, K in dQ);
// - P^T and dS^T (dS in dQ) go from the float32 accumulator fragments
//   straight into bf16 A fragments, with no round trip through shared
//   memory.  That rounding of P (for dV) and dS (for dK and dQ) is the
//   route's one rounding point beyond the bf16 inputs (FlashAttention's
//   practice; the reference keeps them in float32), modelled by
//   kernels/ref.py flash_attention_bwd_tc;
// - dK/dV takes each staged 64-row q tile in two halves of 32 rows, so the
//   float32 dK and dV accumulators (2 x 64 registers at hd = 128) fit
//   beside the scores;
// - hd is zero-padded to 64 or 128 columns in shared memory (cp.async
//   zero-fills the columns past hd); the wrapper pads a head dim that is
//   not a multiple of 8 and slices the result;
// - 99,328 bytes of shared memory per block at hd = 128: two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr int TP = 64 + 4;      // padded row stride of the transposed tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

__device__ __forceinline__ bool unmasked(int qp, int kp, int S, int Tk,
                                         int causal, int window) {
  bool ok = qp < S && kp < Tk;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// dK/dV: Kt, Vt [HDP][TP] (transposed), Qs, Os [BQ][HDP + 1] (row-major),
// Ps, Ds [BQ][TP] (p and ds, indexed [q][key]), Ls, Dl [BQ].
template <int HDP>
constexpr int kv_smem_floats() {
  return 2 * HDP * TP + 2 * BQ * (HDP + 1) + 2 * BQ * TP + 2 * BQ;
}

// dQ: Qt, Ot [HDP][TP] (transposed), Ks, Vs [BK][HDP + 1] (row-major),
// Ds [BK][TP] (ds, indexed [key][q]).
template <int HDP>
constexpr int q_smem_floats() {
  return 2 * HDP * TP + 2 * BK * (HDP + 1) + BK * TP;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int Tk, int Hq, int Hkv,
                      int hd, int causal, int window, float scale) {
  constexpr int HDS = HDP + 1;
  constexpr int CN = HDP / 16;                 // output columns per thread
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);
  float* Vt = Kt + HDP * TP;
  float* Qs = Vt + HDP * TP;
  float* Os = Qs + BQ * HDS;
  float* Ps = Os + BQ * HDS;
  float* Ds = Ps + BQ * TP;
  float* Ls = Ds + BQ * TP;
  float* Dl = Ls + BQ;

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long q_row = (long long)Hq * hd;  // stride of one position
  const long long kv_row = (long long)Hkv * hd;
  const T* kb = k + (long long)b * Tk * kv_row + (long long)hk * hd;
  const T* vb = v + (long long)b * Tk * kv_row + (long long)hk * hd;

  for (int i = tid; i < BK * HDP; i += THREADS) {
    const int c = i / HDP, d = i % HDP;
    float kv = 0.f, vv = 0.f;
    if (k0 + c < Tk && d < hd) {
      kv = to_f32(kb[(long long)(k0 + c) * kv_row + d]);
      vv = to_f32(vb[(long long)(k0 + c) * kv_row + d]);
    }
    Kt[d * TP + c] = kv;
    Vt[d * TP + c] = vv;
  }

  float acc_k[4][CN], acc_v[4][CN];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < CN; ++n) acc_k[a][n] = acc_v[a][n] = 0.f;

  // q tiles holding at least one unmasked (q, k) pair of this key tile
  const int k_last = min(k0 + BK, Tk) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const int i_begin = q_begin / BQ;
  const int i_end = q_end > q_begin ? (q_end + BQ - 1) / BQ : i_begin;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + (long long)b * S * q_row + (long long)h * hd;
    const T* ob = dout + (long long)b * S * q_row + (long long)h * hd;
    const float* lb = lse + ((long long)b * Hq + h) * S;
    const float* db = delta + ((long long)b * Hq + h) * S;
    for (int it = i_begin; it < i_end; ++it) {
      const int q0 = it * BQ;
      __syncthreads();             // K/V staged / previous tile consumed
      for (int i = tid; i < BQ * HDP; i += THREADS) {
        const int r = i / HDP, d = i % HDP;
        float qv = 0.f, ov = 0.f;
        if (q0 + r < S && d < hd) {
          qv = to_f32(qb[(long long)(q0 + r) * q_row + d]);
          ov = to_f32(ob[(long long)(q0 + r) * q_row + d]);
        }
        Qs[r * HDS + d] = qv;
        Os[r * HDS + d] = ov;
      }
      if (tid < BQ) {
        const bool in = q0 + tid < S;
        Ls[tid] = in ? lb[q0 + tid] : 0.f;
        Dl[tid] = in ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T: keys 4ty + a, q rows tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HDP; ++d) {
        const float4 kk = *reinterpret_cast<const float4*>(&Kt[d * TP + ty * 4]);
        const float4 vv = *reinterpret_cast<const float4*>(&Vt[d * TP + ty * 4]);
        const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
        float qa[4], oa[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qa[j] = Qs[(tx + 16 * j) * HDS + d];
          oa[j] = Os[(tx + 16 * j) * HDS + d];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[a][j] = fmaf(ka[a], qa[j], s[a][j]);
            dp[a][j] = fmaf(va[a], oa[j], dp[a][j]);
          }
      }

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const int qp = q0 + r;
        const float l_r = Ls[r], d_r = Dl[r];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int kp = k0 + ty * 4 + a;
          const float p = unmasked(qp, kp, S, Tk, causal, window)
                              ? expf(s[a][j] * scale - l_r) : 0.f;
          s[a][j] = p;
          dp[a][j] = p * (dp[a][j] - d_r) * scale;
        }
        *reinterpret_cast<float4*>(&Ps[r * TP + ty * 4]) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        *reinterpret_cast<float4*>(&Ds[r * TP + ty * 4]) =
            make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
      }
      __syncthreads();

      // dv += p^T dO, dk += ds^T q: keys 4ty + a, columns tx + 16 n
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(&Ps[r * TP + ty * 4]);
        const float4 d4 = *reinterpret_cast<const float4*>(&Ds[r * TP + ty * 4]);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        const float da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int n = 0; n < CN; ++n) {
          const float ov = Os[r * HDS + tx + 16 * n];
          const float qv = Qs[r * HDS + tx + 16 * n];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc_v[a][n] = fmaf(pa[a], ov, acc_v[a][n]);
            acc_k[a][n] = fmaf(da[a], qv, acc_k[a][n]);
          }
        }
      }
    }
  }

  T* dkb = dk + (long long)b * Tk * kv_row + (long long)hk * hd;
  T* dvb = dv + (long long)b * Tk * kv_row + (long long)hk * hd;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + ty * 4 + a;
    if (kp >= Tk) continue;
#pragma unroll
    for (int n = 0; n < CN; ++n) {
      const int col = tx + 16 * n;
      if (col < hd) {
        dkb[(long long)kp * kv_row + col] = from_f32<T>(acc_k[a][n]);
        dvb[(long long)kp * kv_row + col] = from_f32<T>(acc_v[a][n]);
      }
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int Tk, int Hq, int Hkv, int hd, int causal,
                    int window, float scale) {
  constexpr int HDS = HDP + 1;
  constexpr int CN = HDP / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Ot = Qt + HDP * TP;
  float* Ks = Ot + HDP * TP;
  float* Vs = Ks + BK * HDS;
  float* Ds = Vs + BK * HDS;

  const int n_q = (S + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long q_row = (long long)Hq * hd;
  const long long kv_row = (long long)Hkv * hd;
  const T* qb = q + (long long)b * S * q_row + (long long)h * hd;
  const T* ob = dout + (long long)b * S * q_row + (long long)h * hd;
  const T* kb = k + (long long)b * Tk * kv_row + (long long)hk * hd;
  const T* vb = v + (long long)b * Tk * kv_row + (long long)hk * hd;
  const float* lb = lse + ((long long)b * Hq + h) * S;
  const float* db = delta + ((long long)b * Hq + h) * S;

  for (int i = tid; i < BQ * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    float qv = 0.f, ov = 0.f;
    if (q0 + r < S && d < hd) {
      qv = to_f32(qb[(long long)(q0 + r) * q_row + d]);
      ov = to_f32(ob[(long long)(q0 + r) * q_row + d]);
    }
    Qt[d * TP + r] = qv;
    Ot[d * TP + r] = ov;
  }
  float l_r[4], d_r[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty * 4 + a;
    l_r[a] = qp < S ? lb[qp] : 0.f;
    d_r[a] = qp < S ? db[qp] : 0.f;
  }

  float acc[4][CN];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < CN; ++n) acc[a][n] = 0.f;

  // kv tiles holding at least one unmasked pair of this q tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int j_begin = k_begin / BK;
  const int j_end = k_end > k_begin ? (k_end + BK - 1) / BK : j_begin;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();               // Q/dO staged / previous tile consumed
    for (int i = tid; i < BK * HDP; i += THREADS) {
      const int c = i / HDP, d = i % HDP;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < Tk && d < hd) {
        kv = to_f32(kb[(long long)(k0 + c) * kv_row + d]);
        vv = to_f32(vb[(long long)(k0 + c) * kv_row + d]);
      }
      Ks[c * HDS + d] = kv;
      Vs[c * HDS + d] = vv;
    }
    __syncthreads();

    // s = q k^T and dp = dO v^T: q rows 4ty + a, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      const float4 qq = *reinterpret_cast<const float4*>(&Qt[d * TP + ty * 4]);
      const float4 oo = *reinterpret_cast<const float4*>(&Ot[d * TP + ty * 4]);
      const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
      const float oa[4] = {oo.x, oo.y, oo.z, oo.w};
      float ka[4], va[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = Ks[(tx + 16 * j) * HDS + d];
        va[j] = Vs[(tx + 16 * j) * HDS + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[a][j] = fmaf(qa[a], ka[j], s[a][j]);
          dp[a][j] = fmaf(oa[a], va[j], dp[a][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kp = k0 + c;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qp = q0 + ty * 4 + a;
        const float p = unmasked(qp, kp, S, Tk, causal, window)
                            ? expf(s[a][j] * scale - l_r[a]) : 0.f;
        dp[a][j] = p * (dp[a][j] - d_r[a]) * scale;
      }
      *reinterpret_cast<float4*>(&Ds[c * TP + ty * 4]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

    // dq += ds k: q rows 4ty + a, columns tx + 16 n
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float4 d4 = *reinterpret_cast<const float4*>(&Ds[c * TP + ty * 4]);
      const float da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        const float kv = Ks[c * HDS + tx + 16 * n];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][n] = fmaf(da[a], kv, acc[a][n]);
      }
    }
  }

  T* dqb = dq + (long long)b * S * q_row + (long long)h * hd;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + ty * 4 + a;
    if (qp >= S) continue;
#pragma unroll
    for (int n = 0; n < CN; ++n) {
      const int col = tx + 16 * n;
      if (col < hd) dqb[(long long)qp * q_row + col] = from_f32<T>(acc[a][n]);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int S, int Tk, int Hq, int Hkv, int hd, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t kv_smem = sizeof(float) * kv_smem_floats<HDP>();
  const size_t q_smem = sizeof(float) * q_smem_floats<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (err != cudaSuccess) return (int)err;
  if (Tk > 0) {
    const dim3 grid_kv((Tk + BK - 1) / BK, Hkv, B);
    flash_bwd_dkdv_kernel<T, HDP><<<grid_kv, THREADS, kv_smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, S, Tk, Hq,
        Hkv, hd, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_q((S + BQ - 1) / BQ, Hq, B);
  flash_bwd_dq_kernel<T, HDP><<<grid_q, THREADS, q_smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, S, Tk, Hq, Hkv, hd,
      causal, window, scale);
  return (int)cudaGetLastError();
}

// the float32 route (dtype 0)
template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int B, int S, int Tk, int Hq, int Hkv, int hd,
              int causal, int window, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, Hq,
                         Hkv, hd, causal, window, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, Hq,
                         Hkv, hd, causal, window, scale, stream);
  return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk, Hq,
                        Hkv, hd, causal, window, scale, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 route: FlashAttention-2's two kernels on mma.sync.m16n8k16
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BT = 64;          // rows of every staged tile (keys or q rows)
constexpr int THREADS = 128;    // 4 warps, 16 "own" rows each
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A staged tile is BT rows x HDP bf16 columns, row-major; the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8), so the 8 rows that one ldmatrix
// reads at one chunk column fall in 8 different bank groups.
template <int HDP>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  return base + r * (HDP * 2) + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [row0, row0 + BT) of one head of a [B, L, H, hd] tensor (``g`` at
// its (batch, head) origin, ``rs`` elements between rows) into a staged
// tile; rows past L and columns past hd are zero-filled
template <int HDP>
__device__ __forceinline__ void load_tile(uint32_t base, const bf16* g,
                                          long long rs, int row0, int L,
                                          int hd, int tid) {
  constexpr int CPR = HDP / 8;                  // chunks per row
#pragma unroll
  for (int i = tid; i < BT * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < L && c * 8 < hd;
    cp_async16(tile_addr<HDP>(base, r, c),
               ok ? g + (long long)(row0 + r) * rs + c * 8 : g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a . b on one m16n8k16 tile (a row-major, b "col": n rows of k)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The fragments below follow mma.sync's layouts.  In a warp, g = lane / 4
// and cq = 2 (lane % 4).  An accumulator tile d[n][0..3] of 16 rows x 8n
// columns holds (g, 8n + cq), (g, 8n + cq + 1), (g + 8, ...), (g + 8, ...).
//
// Each ldmatrix.x4 below reads a 16 x 16 slice of a staged tile whose first
// row is a multiple of 8, so a lane's swizzle is (lane % 8) and its address
// is (tile + first row) + (its offset for slice 0) ^ (slice << 5): the k16
// slices differ only in the chunk bits that the XOR flips.  The per-lane
// offsets:
// - A fragment (rows r0..r0+15, columns 16 kk..): lane l reads row l % 16,
//   chunk l / 16;
// - B fragments of two 8-column blocks (staged rows n0..n0+15 are the
//   product's n, columns 16 kk.. its k; b[0], b[1] for rows n0.., b[2],
//   b[3] for rows n0 + 8..): row l % 8 + 8 (l / 16), chunk (l / 8) % 2;
// - the same read transposed (staged rows k0..k0+15 are the product's k,
//   columns 16 np.. its n): row l % 8 + 8 ((l / 8) % 2), chunk l / 16.
template <int HDP>
__device__ __forceinline__ uint32_t lane_off(int row, int chunk, int lane) {
  return row * (HDP * 2) + ((chunk ^ (lane & 7)) << 4);
}
template <int HDP>
__device__ __forceinline__ uint32_t a_off(int lane) {
  return lane_off<HDP>(lane & 15, lane >> 4, lane);
}
template <int HDP>
__device__ __forceinline__ uint32_t b_off(int lane) {
  return lane_off<HDP>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1,
                       lane);
}
template <int HDP>
__device__ __forceinline__ uint32_t bt_off(int lane) {
  return lane_off<HDP>((lane & 7) + (((lane >> 3) & 1) << 3), lane >> 4,
                       lane);
}
// tile: staged tile base; row0: first row of the slice; off: the lane's
// offset from a_off / b_off / bt_off; s: the k16 (or n16) slice
template <int HDP>
__device__ __forceinline__ void ldsm(uint32_t tile, int row0, uint32_t off,
                                     int s, uint32_t (&r)[4]) {
  ldsm_x4(tile + row0 * (HDP * 2) + (off ^ (s << 5)), r);
}
template <int HDP>
__device__ __forceinline__ void ldsm_t(uint32_t tile, int row0, uint32_t off,
                                       int s, uint32_t (&r)[4]) {
  ldsm_x4_t(tile + row0 * (HDP * 2) + (off ^ (s << 5)), r);
}

// A fragment of the product's k16 slice kk, straight from an accumulator
// tile whose columns are that k (no round trip through shared memory)
template <int NB>
__device__ __forceinline__ void to_a(const float (&d)[NB][4], int kk,
                                     uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[2 * kk][0], d[2 * kk][1]);
  a[1] = pack_bf16(d[2 * kk][2], d[2 * kk][3]);
  a[2] = pack_bf16(d[2 * kk + 1][0], d[2 * kk + 1][1]);
  a[3] = pack_bf16(d[2 * kk + 1][2], d[2 * kk + 1][3]);
}

template <int HDP>
constexpr int smem_bytes() {                    // six staged tiles + 4 x 64 f32
  return 6 * BT * HDP * 2 + 4 * BT * 4;
}

// dK/dV: one block per (64-key tile, kv head, batch).  Warp w owns keys
// k0 + 16w..+15, the product's M everywhere: S^T = K Q^T and dP^T = V dO^T,
// then P^T and dS^T go from their accumulators into A fragments for
// dV += P^T dO and dK += dS^T Q.  It walks the G q heads of the group and
// their q tiles with an unmasked pair, double-buffering Q, dO, lse and
// delta by cp.async; each staged q tile is taken in two halves of 32 rows
// to bound the registers.
template <int HDP>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         int Tk, int Hq, int Hkv, int hd, int causal,
                         int window, float scale) {
  constexpr int TILE = BT * HDP * 2;
  constexpr int NH = HDP / 8;                   // 8-column blocks of hd
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sK = smem_u32(smem), sV = sK + TILE;
  const uint32_t sQ = sV + TILE;                // [2] tiles
  const uint32_t sO = sQ + 2 * TILE;            // [2] tiles (dO)
  float* Ls = reinterpret_cast<float*>(smem + 6 * TILE);   // [2][64]
  float* Dl = Ls + 2 * BT;                                  // [2][64]

  const int k0 = blockIdx.x * BT;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, cq = 2 * (lane & 3);
  const long long q_row = (long long)Hq * hd;
  const long long kv_row = (long long)Hkv * hd;
  const float scale_log2 = scale * LOG2E;

  const bf16* kb = k + (long long)b * Tk * kv_row + (long long)hk * hd;
  const bf16* vb = v + (long long)b * Tk * kv_row + (long long)hk * hd;
  load_tile<HDP>(sK, kb, kv_row, k0, Tk, hd, tid);
  load_tile<HDP>(sV, vb, kv_row, k0, Tk, hd, tid);

  // q tiles holding at least one unmasked (q, k) pair of this key tile
  const int k_last = min(k0 + BT, Tk) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k_last + window) : S;
  const int i_begin = q_begin / BT;
  const int ni = q_end > q_begin ? (q_end + BT - 1) / BT - i_begin : 0;
  const int total = G * ni;

  auto stage = [&](int t, int st) {             // issue step t into stage st
    const int h = hk * G + t / ni, q0 = (i_begin + t % ni) * BT;
    const long long off = (long long)b * S * q_row + (long long)h * hd;
    load_tile<HDP>(sQ + st * TILE, q + off, q_row, q0, S, hd, tid);
    load_tile<HDP>(sO + st * TILE, dout + off, q_row, q0, S, hd, tid);
    if (tid < BT) {
      const long long row = ((long long)b * Hq + h) * S + q0 + tid;
      const bool in = q0 + tid < S;
      Ls[st * BT + tid] = in ? lse[row] * LOG2E : 0.f;
      Dl[st * BT + tid] = in ? delta[row] : 0.f;
    }
  };

  float acc_k[NH][4], acc_v[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  if (total > 0) stage(0, 0);
  cp_commit();                                  // K, V and step 0
  const int kr = 16 * warp;                     // this warp's staged keys
  const uint32_t oa = a_off<HDP>(lane), ob = b_off<HDP>(lane);
  const uint32_t obt = bt_off<HDP>(lane);
  for (int t = 0; t < total; ++t) {
    const int st = t & 1;
    if (t + 1 < total) stage(t + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const int q0 = (i_begin + t % ni) * BT;
    const uint32_t sQs = sQ + st * TILE, sOs = sO + st * TILE;
    const float* Lt = Ls + st * BT;
    const float* Dt = Dl + st * BT;
    const bool need_mask = k0 + BT > Tk || q0 + BT > S ||
                           (causal && q0 < k0 + BT - 1) ||
                           (window > 0 && q0 + BT - 1 - window >= k0);
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      const int qr = 32 * hf;                   // staged q rows qr..qr+31
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        uint32_t ak[4], av[4], bq[4], bo[4];
        ldsm<HDP>(sK, kr, oa, kk, ak);
        ldsm<HDP>(sV, kr, oa, kk, av);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          ldsm<HDP>(sQs, qr + 16 * np, ob, kk, bq);
          ldsm<HDP>(sOs, qr + 16 * np, ob, kk, bo);
          mma(s[2 * np], ak, bq[0], bq[1]);
          mma(s[2 * np + 1], ak, bq[2], bq[3]);
          mma(dp[2 * np], av, bo[0], bo[1]);
          mma(dp[2 * np + 1], av, bo[2], bo[3]);
        }
      }
      // p = exp(s * scale - lse) on unmasked pairs, ds = p (dp - delta) scale
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qr + 8 * n + cq + (e & 1);     // staged q row
          const int kp = k0 + kr + g8 + 8 * (e >> 1);
          bool ok = true;
          if (need_mask) {
            const int qp = q0 + qc;
            ok = qp < S && kp < Tk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
          }
          const float p = ok ? exp2f(s[n][e] * scale_log2 - Lt[qc]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Dt[qc]) * scale;
        }
      // dV += P^T dO and dK += dS^T Q over the half's 32 q rows
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], da[4];
        to_a(s, kk, pa);
        to_a(dp, kk, da);
#pragma unroll
        for (int np = 0; np < HDP / 16; ++np) {
          uint32_t bo[4], bq[4];
          ldsm_t<HDP>(sOs, qr + 16 * kk, obt, np, bo);
          ldsm_t<HDP>(sQs, qr + 16 * kk, obt, np, bq);
          mma(acc_v[2 * np], pa, bo[0], bo[1]);
          mma(acc_v[2 * np + 1], pa, bo[2], bo[3]);
          mma(acc_k[2 * np], da, bq[0], bq[1]);
          mma(acc_k[2 * np + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                            // stage st consumed
  }
  cp_wait<0>();

  bf16* dkb = dk + (long long)b * Tk * kv_row + (long long)hk * hd;
  bf16* dvb = dv + (long long)b * Tk * kv_row + (long long)hk * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + kr + g8 + 8 * r;
    if (kp >= Tk) continue;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int col = 8 * n + cq;
      if (col < hd) {                           // hd is even: col + 1 too
        const long long o = (long long)kp * kv_row + col;
        *reinterpret_cast<uint32_t*>(dkb + o) =
            pack_bf16(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvb + o) =
            pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
      }
    }
  }
}

// dQ: one block per (64-row q tile, q head, batch).  Warp w owns q rows
// q0 + 16w..+15: S = Q K^T and dP = dO V^T, then dS from its accumulator
// into A fragments for dQ += dS K.  K and V tiles are double-buffered by
// cp.async over the kv tiles with an unmasked pair.
template <int HDP>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int S, int Tk, int Hq, int Hkv, int hd, int causal,
                       int window, float scale) {
  constexpr int TILE = BT * HDP * 2;
  constexpr int NH = HDP / 8;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem), sO = sQ + TILE;
  const uint32_t sK = sO + TILE;                // [2] tiles
  const uint32_t sV = sK + 2 * TILE;            // [2] tiles

  const int n_q = (S + BT - 1) / BT;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BT;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, cq = 2 * (lane & 3);
  const long long q_row = (long long)Hq * hd;
  const long long kv_row = (long long)Hkv * hd;
  const float scale_log2 = scale * LOG2E;
  const long long qoff = (long long)b * S * q_row + (long long)h * hd;
  const bf16* kb = k + (long long)b * Tk * kv_row + (long long)hk * hd;
  const bf16* vb = v + (long long)b * Tk * kv_row + (long long)hk * hd;

  load_tile<HDP>(sQ, q + qoff, q_row, q0, S, hd, tid);
  load_tile<HDP>(sO, dout + qoff, q_row, q0, S, hd, tid);
  const int qw = 16 * warp;                     // this warp's staged rows
  const uint32_t oa = a_off<HDP>(lane), ob = b_off<HDP>(lane);
  const uint32_t obt = bt_off<HDP>(lane);
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + qw + g8 + 8 * r;
    const long long row = ((long long)b * Hq + h) * S + qp;
    l2[r] = qp < S ? lse[row] * LOG2E : 0.f;
    dl[r] = qp < S ? delta[row] : 0.f;
  }

  // kv tiles holding at least one unmasked pair of this q tile
  const int q_last = min(q0 + BT, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int j_begin = k_begin / BT;
  const int nj = k_end > k_begin ? (k_end + BT - 1) / BT - j_begin : 0;

  auto stage = [&](int t, int st) {
    const int kt0 = (j_begin + t) * BT;
    load_tile<HDP>(sK + st * TILE, kb, kv_row, kt0, Tk, hd, tid);
    load_tile<HDP>(sV + st * TILE, vb, kv_row, kt0, Tk, hd, tid);
  };

  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (nj > 0) stage(0, 0);
  cp_commit();                                  // Q, dO and step 0
  for (int t = 0; t < nj; ++t) {
    const int st = t & 1;
    if (t + 1 < nj) stage(t + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const int k0 = (j_begin + t) * BT;
    const uint32_t sKs = sK + st * TILE, sVs = sV + st * TILE;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm<HDP>(sQ, qw, oa, kk, aq);
      ldsm<HDP>(sO, qw, oa, kk, ao);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ldsm<HDP>(sKs, 16 * np, ob, kk, bk);
        ldsm<HDP>(sVs, 16 * np, ob, kk, bv);
        mma(s[2 * np], aq, bk[0], bk[1]);
        mma(s[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ao, bv[0], bv[1]);
        mma(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    const bool need_mask = k0 + BT > Tk || q0 + BT > S ||
                           (causal && q0 < k0 + BT - 1) ||
                           (window > 0 && q0 + BT - 1 - window >= k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool ok = true;
        if (need_mask) {
          const int qp = q0 + qw + g8 + 8 * r;
          const int kp = k0 + 8 * n + cq + (e & 1);
          ok = qp < S && kp < Tk;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
        }
        const float p = ok ? exp2f(s[n][e] * scale_log2 - l2[r]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dl[r]) * scale;
      }
    // dQ += dS K over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      to_a(dp, kk, da);
#pragma unroll
      for (int np = 0; np < HDP / 16; ++np) {
        uint32_t bk[4];
        ldsm_t<HDP>(sKs, 16 * kk, obt, np, bk);
        mma(acc[2 * np], da, bk[0], bk[1]);
        mma(acc[2 * np + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();                            // stage st consumed
  }
  cp_wait<0>();

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + qw + g8 + 8 * r;
    if (qp >= S) continue;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int col = 8 * n + cq;
      if (col < hd)
        *reinterpret_cast<uint32_t*>(dqb + (long long)qp * q_row + col) =
            pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// delta = rowsum(dO * O) [B, Hq, S] in float32 from the bf16 dO and O
// [B, S, Hq, hd]: one warp per (b, s, h) row, hd even.
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ dout,
                       const bf16* __restrict__ out, float* __restrict__ delta,
                       int B, int S, int Hq, int hd) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * S * Hq) return;
  const __nv_bfloat162* d2 =
      reinterpret_cast<const __nv_bfloat162*>(dout + row * hd);
  const __nv_bfloat162* o2 =
      reinterpret_cast<const __nv_bfloat162*>(out + row * hd);
  float acc = 0.f;
  for (int i = lane; i < hd / 2; i += 32) {
    const float2 a = __bfloat1622float2(d2[i]);
    const float2 c = __bfloat1622float2(o2[i]);
    acc = fmaf(a.x, c.x, acc);
    acc = fmaf(a.y, c.y, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const int h = (int)(row % Hq);
    const long long bs = row / Hq;              // b * S + s
    const int s = (int)(bs % S), bb = (int)(bs / S);
    delta[((long long)bb * Hq + h) * S + s] = acc;
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int S, int Tk, int Hq, int Hkv, int hd,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_tc_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * S * Hq;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const bf16*)dout, (const bf16*)out, (float*)delta, B, S, Hq, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Tk > 0) {
    const dim3 grid_kv((Tk + BT - 1) / BT, Hkv, B);
    flash_bwd_dkdv_tc_kernel<HDP><<<grid_kv, THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, S, Tk,
        Hq, Hkv, hd, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_q((S + BT - 1) / BT, Hq, B);
  flash_bwd_dq_tc_kernel<HDP><<<grid_q, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, S, Tk, Hq, Hkv, hd,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv share
// it); lse and delta are float32 [B, Hq, S].  float32 reads delta, which
// the caller computed, and ignores out; bfloat16 writes delta = rowsum(dout
// * out) itself (hd must be a multiple of 8 and every pointer 16-byte
// aligned, which the wrapper ensures).  Then the dK/dV kernel and the dQ
// kernel, all on ``stream``.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int Tk, int Hq, int Hkv, int hd, int causal,
    int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (hd <= 0 || hd > 128 || Hkv <= 0 || Hq % Hkv != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk,
                            Hq, Hkv, hd, causal, window, scale, st);
  if (dtype == 1) {
    if (hd % 8 != 0) return (int)cudaErrorInvalidValue;
    if (hd <= 64)
      return tc::launch<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                            Tk, Hq, Hkv, hd, causal, window, scale, st);
    return tc::launch<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                           Tk, Hq, Hkv, hd, causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
