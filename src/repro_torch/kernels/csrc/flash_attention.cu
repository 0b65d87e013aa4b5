// Flash-attention forward for the decoder-LM prefill and training forward,
// hand-written for Hopper (sm_90a).
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
// Two routes, chosen by the C entry's dtype argument (a route by type, not
// a fallback: a bf16 call the tensor-core kernel cannot take raises):
//
// dtype 0, float32: CUDA cores in full float32 (the port keeps float32
// products off the tensor cores, device.py switches TF32 off).  The first
// version of this kernel:
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
//   the 16 lanes of a half-warp with shuffles;
// - heaviest causal tiles are launched first (q tiles in reverse order);
// - rows and keys past S and T are masked or not stored.
//
// dtype 1, bfloat16: tensor cores, FlashAttention-3's structure without its
// ping-pong scheduling (namespace tc below):
// - one 288-thread block per (q tile of 128 rows, q head, batch): two
//   consumer warpgroups of 64 rows and one producer warp;
// - the producer's lane 0 loads the q tile once and the K and V tiles of
//   each visited kv tile (64 keys) by TMA into a 2-stage ring, 128-byte
//   swizzled, signalled by mbarriers (full per tile, empty per stage);
// - S = Q K^T by wgmma.m64n64k16 with both operands in shared memory and a
//   float32 accumulator; the online softmax runs in registers on the
//   accumulator fragment (row max and sum over the quad by shuffles,
//   exp2f on scores pre-scaled by hd^-0.5 log2 e);
// - P is rounded to bf16 in registers and fed as wgmma's register A
//   operand for O += P V; V is read through an MN-major descriptor, so it
//   is never transposed in memory.  This rounding of P (FlashAttention's
//   practice; the reference keeps P in float32) is the route's one
//   rounding point beyond the bf16 inputs, modelled by
//   kernels/ref.py attention_lse_tc;
// - the same visiting rule and heaviest-first order as the float32 route;
// - hd is zero-padded to 64 or 128 columns in shared memory (TMA fills
//   columns past hd with zeros, which add nothing to either product); the
//   wrapper pads a head dim that is not a multiple of 8 (TMA's 16-byte
//   stride rule) and slices the result;
// - 99 KB of shared memory at hd = 128, but one block per SM: each
//   consumer thread holds its share of the 64 x hd output accumulator, the
//   64 x 64 scores and P in registers (142 at hd = 128), and 288 threads
//   of that take 41 K of the SM's 64 K registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper_tc.cuh"

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr int QP = BQ + 4;      // padded row stride of the transposed tiles
constexpr int KP = BK + 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// the float32 route (dtype 0)
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

// ---------------------------------------------------------------------------
// bf16 route: warpgroup kernel on the tensor cores (wgmma + TMA)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;         // q rows per block: two consumer warpgroups
constexpr int BK = 64;          // keys per kv tile
constexpr int NS = 2;           // stages of the K/V ring
constexpr int THREADS = 288;    // 2 consumer warpgroups + 1 producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// the reference's masked score -1e30, in the log2 domain the kernel works in
// (so that lse = m * ln 2 + log l gives -1e30 for a row with no key)
constexpr float NEG2 = -1e30f * LOG2E;

// Shared memory, every tile 1024-byte aligned (the 128-byte swizzle atom is
// 8 rows of 128 bytes).  A tile of R rows x HDP columns is stored as HDP/64
// chunks of R rows x 64 columns (128 bytes a row), each one TMA box.
template <int HDP>
struct Smem {
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + NS * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + NS * KV_BYTES;
  // mbarriers: q full, k full [NS], v full [NS], stage empty [NS]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * NS);
  static constexpr int ALLOC = BYTES + 1024;   // room to align the base
};

// Block (q tile of 128 rows, q head, batch).  Threads 0-255 are two
// consumer warpgroups of 64 rows each; warp 8 is the producer, whose lane 0
// issues every TMA load.  A consumer thread holds rows r0 and r0 + 8 of its
// warpgroup's slab: in every 8-column block n of an accumulator, registers
// 4n..4n+3 are (r0, c), (r0, c+1), (r0+8, c), (r0+8, c+1), c = 8n + 2(lane%4).
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int S, int Tk, int Hq, int Hkv, int hd, int causal,
                    int window, float scale_log2) {
  using L = Smem<HDP>;
  constexpr int CH = HDP / 64;                  // 64-column chunks
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q_OFF;
  const uint32_t sK = base + L::K_OFF;
  const uint32_t sV = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_k = bar_q + 8;             // + 8 s
  const uint32_t bar_v = bar_k + 8 * NS;
  const uint32_t bar_e = bar_v + 8 * NS;

  const int n_q = (S + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  // kv tiles holding at least one unmasked (q, k) pair of this q tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int j_begin = k_begin / BK;
  const int n_tiles = k_end > k_begin ? (k_end + BK - 1) / BK - j_begin : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 8);              // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {                             // producer warp
    if (tid == 256) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < CH; ++c)
        tma_load(sQ + c * BQ * 128, &qmap, bar_q, 64 * c, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS;
        const int k0 = (j_begin + it) * BK;
        mbar_wait(bar_e + 8 * s, ((it / NS) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, L::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sK + s * L::KV_BYTES + c * BK * 128, &kmap, bar_k + 8 * s,
                   64 * c, hk, k0, b);
        mbar_expect_tx(bar_v + 8 * s, L::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sV + s * L::KV_BYTES + c * BK * 128, &vmap, bar_v + 8 * s,
                   64 * c, hk, k0, b);
      }
    }
    return;
  }

  const int wg = tid >> 7;                      // consumer warpgroup
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int qw0 = q0 + 64 * wg;                 // first row of the slab
  const int r0 = qw0 + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint32_t sQw = sQ + wg * 64 * 128;

  float o[CH][32];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % NS;
    const uint32_t ph = (it / NS) & 1;
    const int k0 = (j_begin + it) * BK;
    const uint32_t sKs = sK + s * L::KV_BYTES, sVs = sV + s * L::KV_BYTES;

    // S = Q K^T (raw scores, float32)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(bar_k + 8 * s, ph);
    reg_fence(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const int c = kk / 4, kin = kk % 4;
      wgmma_ss(sc, make_desc(sQw + c * BQ * 128 + kin * 32, 16, 1024),
               make_desc(sKs + c * BK * 128 + kin * 32, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    reg_fence(sc);

    // scale into the log2 domain, mask, online softmax in registers
    const bool need_mask = k0 + BK > Tk || (causal && k0 + BK - 1 > qw0) ||
                           (window > 0 && k0 <= qw0 + 63 - window);
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = r0 + 8 * (e >> 1);
          const int kp = k0 + 8 * n + cq + (e & 1);
          bool ok = kp < Tk;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          sc[4 * n + e] = ok ? sc[4 * n + e] * scale_log2 : NEG2;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    // P to bf16, straight into wgmma's register A fragments (one per k16
    // slice of keys)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V, V read MN-major (never transposed in memory)
    mbar_wait(bar_v + 8 * s, ph);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(pa[kk]);
#pragma unroll
    for (int c = 0; c < CH; ++c) reg_fence(o[c]);
    wg_fence();
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[c], pa[kk],
                 make_desc(sVs + c * BK * 128 + kk * 16 * 128, BK * 128,
                           1024));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < CH; ++c) reg_fence(o[c]);
    if (lane == 0) mbar_arrive(bar_e + 8 * s);
  }

  // epilogue: l summed over the quad, out = acc / max(l, 1e-30) in bf16,
  // lse = m ln 2 + log(max(l, 1e-30)) in float32
  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-30f);
  }
  const long long q_row = (long long)Hq * hd;
  __nv_bfloat16* ob = out + (long long)b * S * q_row + (long long)h * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * c + 8 * n + cq;
        if (col < hd)                           // hd is even: col + 1 too
          *reinterpret_cast<uint32_t*>(ob + (long long)qp * q_row + col) =
              pack_bf16(o[c][4 * n + 2 * r] / lc[r],
                        o[c][4 * n + 2 * r + 1] / lc[r]);
      }
    if ((lane & 3) == 0)
      lse[((long long)b * Hq + h) * S + qp] = m[r] * LN2 + logf(lc[r]);
  }
}

// TMA map of a contiguous [B, L, H, hd] bf16 tensor, read in boxes of
// 64 columns x ``rows`` rows of one head; columns past hd and rows past L
// load as zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int hd,
             int rows) {
  EncodeTiled enc = encoder();
  if (!enc) return ENCODE_ERROR;
  const cuuint64_t rows_l = L > 1 ? (cuuint64_t)L : 1;   // T may be 0
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, rows_l,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 rows_l * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int S, int Tk, int Hq, int Hkv, int hd, int causal,
           int window, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int err = make_map(&qmap, q, B, S, Hq, hd, BQ);
  if (!err) err = make_map(&kmap, k, B, Tk, Hkv, hd, BK);
  if (!err) err = make_map(&vmap, v, B, Tk, Hkv, hd, BK);
  if (err) return err;
  const int smem = Smem<HDP>::ALLOC;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_tc_kernel<HDP><<<grid, THREADS, smem, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)out, (float*)lse, S, Tk, Hq, Hkv, hd,
      causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel;
// hd must be a multiple of 8 and every pointer 16-byte aligned, which the
// wrapper ensures).  q, k, v and out share the dtype.
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
  if (dtype == 1) {
    if (hd % 8 != 0) return (int)cudaErrorInvalidValue;
    if (hd <= 64)
      return tc::launch<64>(q, k, v, out, lse, B, S, Tk, Hq, Hkv, hd, causal,
                            window, scale, st);
    return tc::launch<128>(q, k, v, out, lse, B, S, Tk, Hq, Hkv, hd, causal,
                           window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" long long flash_attention_fwd_smem_bytes(int hd) {
  if (hd <= 32) return (long long)sizeof(float) * smem_floats<32>();
  if (hd <= 64) return (long long)sizeof(float) * smem_floats<64>();
  return (long long)sizeof(float) * smem_floats<128>();
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  if (code >= tc::ENCODE_ERROR) {
    static char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - tc::ENCODE_ERROR);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}
