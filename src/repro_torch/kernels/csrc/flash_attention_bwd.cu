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
// card's ~295 in bf16.  These two kernels do seven (each recomputes s and
// dp).
//
// What the design does about it (a first, simple version: CUDA cores in
// float32, no tensor cores, no TMA, no pipelining):
// - two kernels, as on the TPU.  dK/dV: one 256-thread block per (64-key
//   tile, kv head, batch) that loops over the G q heads of its group and
//   over the 64-row q tiles holding an unmasked pair (causal: from the
//   diagonal on; window: up to the tile's last key + window).  So GQA is
//   summed in place in registers, where the TPU version expands k/v to Hq
//   heads and group-sums a [B, Hq, T, hd] float32 buffer afterwards.  dQ:
//   one block per (64-row q tile, q head, batch) looping over kv tiles, as
//   the forward kernel;
// - operands staged in shared memory as float32, each in the layout its
//   products read: the tile that a thread reads 4 rows of at once is
//   stored transposed ([hd][64 + 4], a float4 load), the tile whose rows
//   the 16 lanes of a half-warp read one each is stored row-major with an
//   odd stride (hd + 1), so those lanes hit 16 different banks;
// - thread (ty, tx) of a 16 x 16 grid owns 4 "own" rows (keys in the dK/dV
//   kernel, q rows in the dQ kernel) 4ty..4ty+3 and 4 "other" rows
//   tx, tx+16, tx+32, tx+48 of each 64 x 64 score tile, and output columns
//   tx, tx+16, ..., so every accumulator stays in registers;
// - p and ds go through shared memory once per tile for the second-stage
//   products; 171,008 bytes (dK/dV) and 153,088 bytes (dQ) of shared
//   memory at hd = 128, one block per SM;
// - heaviest causal tiles first: key tiles in ascending order (the first
//   key tile meets every q tile), q tiles in descending order;
// - rows and keys past S and T load as zeros and are masked, so any S and
//   T work (the TPU kernels drop a ragged tail: n_q = S // block_q).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr int TP = 64 + 4;      // padded row stride of the transposed tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv share it);
// lse and delta are float32 [B, Hq, S].  Launches the dK/dV kernel, then
// the dQ kernel, on ``stream``.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int S, int Tk, int Hq, int Hkv, int hd, int causal, int window,
    float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (hd <= 0 || hd > 128 || Hkv <= 0 || Hq % Hkv != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Tk,
                            Hq, Hkv, hd, causal, window, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                    S, Tk, Hq, Hkv, hd, causal, window, scale,
                                    st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
