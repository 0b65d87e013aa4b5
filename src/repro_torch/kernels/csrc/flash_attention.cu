// Flash-attention forward for the decoder-LM prefill, hand-written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py flash_attention_fwd
// (_fwd_kernel, pallas_call at :89).  Online-softmax attention over
// q [B, S, Hq, hd] and k/v [B, T, Hkv, hd] with native GQA (q head h reads
// kv head h / (Hq / Hkv)), a causal mask and a sliding window
// (k > q - window), returning out [B, S, Hq, hd] in q's dtype and the
// per-row log-sum-exp lse [B, Hq, S] in float32.  The arithmetic is the
// TPU kernel's: scores (q . k) * hd^-0.5 in float32, masked scores set to
// -1e30 (finite, so a row that is masked across a whole tile takes p = 1
// until a real key arrives and alpha = exp(-1e30 - m) = 0 erases it),
// running max m, sum l and accumulator in float32, l clamped at 1e-30,
// out = acc / l and lse = m + log(l).
//
// What bounds it on this card: operations.  At Llama-3.2-3B's prefill
// (S = 2048, 24 q heads, hd = 128, causal) each (b, head) does
// 4 * hd * S(S+1)/2 flop against 3 * S * hd * 2 bytes of q/k/v; the work is
// ~500x the bytes, far above the card's ~295 flop/byte ridge in bf16.
//
// What the design does about it (a first, simple version: CUDA cores in
// float32, no tensor cores, no TMA, no pipelining):
// - one 256-thread block per (q tile of 64 rows, q head, batch); the TPU
//   kernel's sequential kv grid axis becomes a loop over 64-key tiles
//   inside the block, and only the tiles that hold an unmasked pair are
//   visited (causal: up to the tile's last row; window: from its first
//   row's first key), which is the TPU kernel's `run` skip;
// - q tile staged once, k and then v tiles staged per step in shared
//   memory as float32 (q and k transposed, so a thread reads 4 rows or 4
//   keys as one 16-byte word); k and v share one buffer;
// - thread (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 in both
//   products: a 4 x 4 tile of scores and a 4 x (hd/16) tile of the output
//   accumulator, all in registers; the row max and row sum reduce over
//   the 16 lanes of a half-warp with shuffles, so m and l sit in registers
//   and no extra barrier is needed for the softmax;
// - heaviest causal tiles are launched first (q tiles in reverse order);
// - rows and keys past S and T are masked or not stored, so any S and T
//   work (the TPU kernel asserts divisibility by its tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr int QP = BQ + 4;      // padded row stride of the transposed tiles
constexpr int KP = BK + 4;
constexpr float NEG_INF = -1e30f;

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

template <int HDP>
constexpr int smem_floats() {
  // Qs [HDP][QP] + one k/v buffer (k as [HDP][KP], v as [BK][HDP])
  // + Ps [BK][QP]
  return HDP * QP + (HDP * KP > BK * HDP ? HDP * KP : BK * HDP) + BK * QP;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Tk, int Hq, int Hkv,
                 int hd, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [HDP][QP], q transposed
  float* KVs = Qs + HDP * QP;                    // k^T [HDP][KP] | v [BK][HDP]
  float* Ps = KVs + (HDP * KP > BK * HDP ? HDP * KP : BK * HDP);  // [BK][QP]

  constexpr int CN = HDP / 16;                   // output columns per thread
  const int n_q = (S + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const long long q_row = (long long)Hq * hd;    // stride of one position
  const long long kv_row = (long long)Hkv * hd;
  const T* qb = q + (long long)b * S * q_row + (long long)h * hd;
  const T* kb = k + (long long)b * Tk * kv_row + (long long)hk * hd;
  const T* vb = v + (long long)b * Tk * kv_row + (long long)hk * hd;

  for (int i = tid; i < BQ * HDP; i += THREADS) {
    const int r = i / HDP, d = i % HDP;
    float val = 0.f;
    if (q0 + r < S && d < hd) val = to_f32(qb[(long long)(q0 + r) * q_row + d]);
    Qs[d * QP + r] = val;
  }

  float m[4], l[4], acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
  }

  // kv tiles holding at least one unmasked (q, k) pair of this q tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int j_begin = k_begin / BK;
  const int j_end = k_end > k_begin ? (k_end + BK - 1) / BK : j_begin;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK;
    __syncthreads();               // Qs written / previous tile's v consumed
    for (int i = tid; i < BK * HDP; i += THREADS) {
      const int c = i / HDP, d = i % HDP;
      float val = 0.f;
      if (k0 + c < Tk && d < hd) val = to_f32(kb[(long long)(k0 + c) * kv_row + d]);
      KVs[d * KP + c] = val;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * QP + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&KVs[d * KP + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], bv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx * 4 + c;
        bool ok = kp < Tk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][c] = ok ? s[i][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        ps += s[i][c];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + c) * QP + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();               // Ps complete, k tile consumed

    for (int i = tid; i < BK * HDP; i += THREADS) {
      const int c = i / HDP, d = i % HDP;
      float val = 0.f;
      if (k0 + c < Tk && d < hd) val = to_f32(vb[(long long)(k0 + c) * kv_row + d]);
      KVs[c * HDP + d] = val;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[c * QP + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float vv[CN];
#pragma unroll
      for (int n = 0; n < CN; ++n) vv[n] = KVs[c * HDP + tx * CN + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < CN; ++n) acc[i][n] = fmaf(pv[i], vv[n], acc[i][n]);
    }
  }

  T* ob = out + (long long)b * S * q_row + (long long)h * hd;
  float* lb = lse + ((long long)b * Hq + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < CN; ++n) {
      const int col = tx * CN + n;
      if (col < hd) ob[(long long)qp * q_row + col] = from_f32<T>(acc[i][n] / lc);
    }
    if (tx == 0) lb[qp] = m[i] + logf(lc);
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int S, int Tk, int Hq, int Hkv, int hd, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, HDP><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, S, Tk, Hq,
      Hkv, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int S, int Tk, int Hq, int Hkv, int hd,
              int causal, int window, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, lse, B, S, Tk, Hq, Hkv, hd, causal,
                         window, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, lse, B, S, Tk, Hq, Hkv, hd, causal,
                         window, scale, stream);
  return launch<T, 128>(q, k, v, out, lse, B, S, Tk, Hq, Hkv, hd, causal,
                        window, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int B, int S, int Tk, int Hq,
                                          int Hkv, int hd, int causal,
                                          int window, float scale, int dtype,
                                          void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (hd <= 0 || hd > 128 || Hkv <= 0 || Hq % Hkv != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, lse, B, S, Tk, Hq, Hkv, hd, causal,
                            window, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, lse, B, S, Tk, Hq, Hkv, hd,
                                    causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" long long flash_attention_fwd_smem_bytes(int hd) {
  if (hd <= 32) return (long long)sizeof(float) * smem_floats<32>();
  if (hd <= 64) return (long long)sizeof(float) * smem_floats<64>();
  return (long long)sizeof(float) * smem_floats<128>();
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
