// Fused softmax cross-entropy over a large vocabulary, hand-written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_xent.py fused_softmax_xent_fwd
// (_xent_kernel, pallas_call at :60).  Per row t of h [T, d] and the
// unembedding W [d, V] (float32 or bfloat16, upcast to float32 on load):
//   loss[t] = m + log(max(l, 1e-30)) - gold
// where m and l are the running max and sum of exp(logit - m) over the
// vocabulary and gold the logit at labels[t], taken tile by tile over the
// vocabulary so that the [T, V] logits are never written to device memory.
// A label outside [0, V) contributes gold = 0, as on the TPU.
//
// What bounds it on this card: operations.  Llama-3.2-3B's 1,024-position
// loss chunk (d = 3,072, V = 128,256) is 2 * T * d * V = 807 GFLOP against
// ~0.8 GB of W and h: three orders of magnitude above the ridge.
//
// What the design does about it (a first, simple version: CUDA cores in
// float32, no tensor cores, no TMA):
// - the product is this kernel's own register-tiled SGEMM: a 256-thread
//   block computes 128 rows x 128 vocabulary columns, 8 x 8 per thread
//   (rows 4ty..4ty+3 and 64 + 4ty.., columns 4tx.. and 64 + 4tx..), from
//   16-deep slices of h (stored transposed, row stride 132 so the
//   transposing stores do not collide in a bank) and of W in shared
//   memory; the next slice is read from device memory into registers
//   while the current one is multiplied;
// - the TPU kernel walks the vocabulary axis in order on one core with
//   (m, l, gold) in VMEM scratch.  Here blocks run in parallel, and at
//   T = 1,024 there are only 8 row tiles for 132 SMs, so the grid is
//   (row tile, vocabulary split): each block walks its share of the
//   vocabulary tiles, updating (m, l, gold) per row in registers after
//   every tile (the 16 lanes that share a row reduce with shuffles), and
//   writes one partial (m, l, gold) per row;
// - a second, small kernel merges the splits of each row by the
//   log-sum-exp rule, M = max m_s, L = sum l_s exp(m_s - M), and writes
//   M + log(max(L, 1e-30)) - sum gold_s;
// - the ragged last vocabulary tile is masked (its columns take no part
//   in m, l or gold), so any V works; the TPU kernel asserts V % 512 == 0,
//   which Llama's V = 128,256 does not meet.
// That kernel takes float32, and bfloat16 that the tensor-core route below
// cannot take (d not a multiple of 8, a row pitch of W that is not, or a
// pointer not 16-byte aligned).
//
// W [d, V] is read through its row pitch ldw (>= V), so it may be the
// [:, :V] view of a [d, ceil8(V)] buffer: an odd vocabulary (granite-moe's
// 49,155, whisper-tiny's 51,865, internvl2-2b's 92,553) then meets TMA's
// rule that rows start 16 bytes apart.  bfloat16 with d % 8 == 0,
// ldw % 8 == 0 and 16-byte aligned pointers (TMA's stride and address
// rules) takes the tensor cores (xent_partial_tc_kernel below, the tile
// mainloop of xent_tc.cuh): the same grid of (128-row tile, vocabulary
// split), each block walking its 256-column vocabulary tiles, h tiles read
// K-major and W tiles MN-major by TMA into a 4-stage ring, S = h W by
// wgmma into float32 accumulators.  bf16 x bf16 products are exact in
// float32, so this computes what the reference computes (both operands
// upcast to float32) up to the order of summation.  The online (m, l, gold)
// update runs on the accumulator fragments: each thread holds 2 rows x 64
// columns of a tile, and the four lanes of a quad, which share a row,
// reduce the tile's max with shuffles; l stays a per-lane partial sum
// under the row's common max until the end.  The ragged last vocabulary
// tile loads zeros at and past V (the pitch's pad columns are never read),
// and those columns are masked.
//
// Both routes end in the merge kernel, which also writes each row's
// log-sum-exp lse = M + log(max(L, 1e-30)) in float32 when asked (the
// backward, fused_xent_bwd.cu, starts from it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xent_tc.cuh"

namespace {

constexpr int BR = 128;         // rows per block
constexpr int BV = 128;         // vocabulary columns per tile
constexpr int BD = 16;          // depth of one staged slice
constexpr int THREADS = 256;    // 16 x 16 thread grid, 8 x 8 outputs each
constexpr int AP = BR + 4;      // padded row stride of the transposed h slice
constexpr int LOADS = BR * BD / THREADS;   // elements each thread stages (8)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Element e of a thread's share of one slice is index tid + e * THREADS of
// the h slice ([BR][BD], row-major) and of the W slice ([BD][BV]); both
// are read from device memory into registers, zero past T, d and V.
template <typename T>
__device__ __forceinline__ void load_slice(const T* __restrict__ h,
                                           const T* __restrict__ W,
                                           float (&ha)[LOADS],
                                           float (&wa)[LOADS], int tid,
                                           int r0, int v0, int k0, int T_rows,
                                           int d, int V, int ldw) {
#pragma unroll
  for (int e = 0; e < LOADS; ++e) {
    const int idx = tid + e * THREADS;
    const int r = idx / BD, kk = idx % BD;
    const int gr = r0 + r, gk = k0 + kk;
    ha[e] = (gr < T_rows && gk < d) ? to_f32(h[(long long)gr * d + gk]) : 0.f;
    const int wk = idx / BV, c = idx % BV;
    const int gwk = k0 + wk, gc = v0 + c;
    wa[e] = (gwk < d && gc < V) ? to_f32(W[(long long)gwk * ldw + gc]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
xent_partial_kernel(const T* __restrict__ h, const T* __restrict__ W,
                    const int* __restrict__ labels, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_g,
                    int T_rows, int d, int V, int ldw, int n_split) {
  __shared__ __align__(16) float As[BD * AP];   // h slice, [depth][row]
  __shared__ __align__(16) float Bs[BD * BV];   // W slice, [depth][column]

  const int r0 = blockIdx.x * BR;
  const int split = blockIdx.y;
  const int n_vt = (V + BV - 1) / BV;
  // an even share of the vocabulary tiles; every split gets >= 1 tile
  const int vt_begin = (int)((long long)n_vt * split / n_split);
  const int vt_end = (int)((long long)n_vt * (split + 1) / n_split);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  int lab[8];
  float m_run[8], l_run[8], gold[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + ty * 4 + (i & 3) + (i >> 2) * 64;
    lab[i] = r < T_rows ? labels[r] : -1;
    m_run[i] = -1e30f;
    l_run[i] = 0.f;
    gold[i] = 0.f;
  }

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * BV;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float ha[LOADS], wa[LOADS];
    load_slice(h, W, ha, wa, tid, r0, v0, 0, T_rows, d, V, ldw);
    for (int k0 = 0; k0 < d; k0 += BD) {
      __syncthreads();             // previous slice consumed
#pragma unroll
      for (int e = 0; e < LOADS; ++e) {
        const int idx = tid + e * THREADS;
        As[(idx % BD) * AP + idx / BD] = ha[e];
        Bs[idx] = wa[e];
      }
      __syncthreads();
      if (k0 + BD < d)
        load_slice(h, W, ha, wa, tid, r0, v0, k0 + BD, T_rows, d, V,
                   ldw);
#pragma unroll
      for (int kk = 0; kk < BD; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * AP + ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * AP + 64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * BV + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk * BV + 64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // online (m, l, gold) update of this tile; a row's 128 columns are
    // spread over the 16 lanes (tx) of one half-warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = v0 + tx * 4 + (j & 3) + (j >> 2) * 64;
        if (c < V) {
          mx = fmaxf(mx, acc[i][j]);
          if (c == lab[i]) gold[i] += acc[i][j];
        } else {
          acc[i][j] = -INFINITY;
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) ps += expf(acc[i][j] - m_new);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + ps;
      m_run[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float g = gold[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) g += __shfl_xor_sync(0xffffffffu, g, o);
    const int r = r0 + ty * 4 + (i & 3) + (i >> 2) * 64;
    if (tx == 0 && r < T_rows) {
      const long long at = (long long)split * T_rows + r;
      part_m[at] = m_run[i];
      part_l[at] = l_run[i];
      part_g[at] = g;
    }
  }
}

__global__ void xent_merge_kernel(const float* __restrict__ part_m,
                                  const float* __restrict__ part_l,
                                  const float* __restrict__ part_g,
                                  float* __restrict__ loss,
                                  float* __restrict__ lse, int T_rows,
                                  int n_split) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= T_rows) return;
  float M = -1e30f;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, part_m[(long long)s * T_rows + r]);
  float L = 0.f, g = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long at = (long long)s * T_rows + r;
    L += part_l[at] * expf(part_m[at] - M);
    g += part_g[at];
  }
  const float lse_r = M + logf(fmaxf(L, 1e-30f));
  loss[r] = lse_r - g;
  if (lse) lse[r] = lse_r;
}

template <typename T>
int launch(const void* h, const void* W, const void* labels, void* loss,
           void* lse, void* part, int T_rows, int d, int V, int ldw,
           int n_split, cudaStream_t stream) {
  float* pm = (float*)part;
  float* pl = pm + (long long)n_split * T_rows;
  float* pg = pl + (long long)n_split * T_rows;
  const dim3 grid((T_rows + BR - 1) / BR, n_split);
  xent_partial_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)h, (const T*)W, (const int*)labels, pm, pl, pg, T_rows, d, V,
      ldw, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xent_merge_kernel<<<(T_rows + 255) / 256, 256, 0, stream>>>(
      pm, pl, pg, (float*)loss, (float*)lse, T_rows, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 route: the tensor cores (wgmma + TMA)
// ---------------------------------------------------------------------------

namespace xtc {

constexpr int FWD_NS = 4;       // stages of the ring: 4 x 48 KB

// Block (128-row tile, vocabulary split), the CUDA-core kernel's grid.
__global__ void __launch_bounds__(THREADS, 1)
xent_partial_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const int* __restrict__ labels,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_g, int T_rows, int d, int V,
                       int n_split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  ring_init<1, FWD_NS>(base);
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_vt = (V + BN - 1) / BN;
  // an even share of the vocabulary tiles; every split gets >= 1 tile
  const int vt_begin = (int)((long long)n_vt * split / n_split);
  const int vt_end = (int)((long long)n_vt * (split + 1) / n_split);
  const int n_k = (d + BK - 1) / BK;
  const int tid = threadIdx.x;
  int it = 0;
  if (tid >= 256) {                             // producer warp
    if (tid == 256)
      for (int vt = vt_begin; vt < vt_end; ++vt)
        produce<false, 1, FWD_NS>(base, &hmap, &hmap, &wmap, m0, vt * BN, V,
                                  0, n_k, it);
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int lab[2];
  float m_run[2], l_run[2], gold[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lab[i] = r0 + 8 * i < T_rows ? labels[r0 + 8 * i] : -1;
    m_run[i] = -1e30f;
    l_run[i] = 0.f;
    gold[i] = 0.f;
  }
  float acc[ACC];
  zero(acc);

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    consume<false, 1, FWD_NS>(base, acc, wg, lane, n_k, false, it);
    const int v0 = vt * BN;
    const bool ragged = v0 + BN > V;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = v0 + 8 * n + cq + e;
          const float x = acc[4 * n + 2 * i + e];
          if (!ragged || c < V) {
            mx = fmaxf(mx, x);
            if (c == lab[i]) gold[i] += x;
          }
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = v0 + 8 * n + cq + e;
          if (!ragged || c < V) ps += expf(acc[4 * n + 2 * i + e] - m_new);
        }
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + ps;
      m_run[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i], g = gold[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    g += __shfl_xor_sync(0xffffffffu, g, 1);
    g += __shfl_xor_sync(0xffffffffu, g, 2);
    const int r = r0 + 8 * i;
    if ((lane & 3) == 0 && r < T_rows) {
      const long long at = (long long)split * T_rows + r;
      part_m[at] = m_run[i];
      part_l[at] = l;
      part_g[at] = g;
    }
  }
}

int launch(const void* h, const void* W, const void* labels, void* loss,
           void* lse, void* part, int T_rows, int d, int V, int ldw,
           int n_split, cudaStream_t stream) {
  CUtensorMap hmap, wmap;
  int err = make_map_2d(&hmap, h, T_rows, d, d, BM);
  if (!err) err = make_map_2d(&wmap, W, d, V, ldw, BK);
  if (err) return err;
  const int smem = Ring<1, FWD_NS>::alloc(0);
  cudaError_t e = cudaFuncSetAttribute(
      xent_partial_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  float* pm = (float*)part;
  float* pl = pm + (long long)n_split * T_rows;
  float* pg = pl + (long long)n_split * T_rows;
  const dim3 grid((T_rows + BM - 1) / BM, n_split);
  xent_partial_tc_kernel<<<grid, THREADS, smem, stream>>>(
      hmap, wmap, (const int*)labels, pm, pl, pg, T_rows, d, V, n_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  xent_merge_kernel<<<(T_rows + 255) / 256, 256, 0, stream>>>(
      pm, pl, pg, (float*)loss, (float*)lse, T_rows, n_split);
  return (int)cudaGetLastError();
}

}  // namespace xtc

// dtype: 0 = float32, 1 = bfloat16 (h and W share it); h [T, d] contiguous;
// W [d, V] with rows ldw >= V elements apart; labels int32 [T]; loss
// float32 [T]; lse: float32 [T] or null; part: float32 scratch of
// 3 * n_split * T (partial m, l and gold per split and row).
// tensor_cores = 1 takes the bf16 tensor-core route, which needs dtype 1,
// d % 8 == 0, ldw % 8 == 0 and 16-byte aligned h and W (the wrapper routes
// by exactly that) and n_split in [1, ceil(V / 256)]; 0 the CUDA-core
// kernel, n_split in [1, ceil(V / 128)].
extern "C" int fused_xent_fwd_launch(const void* h, const void* W,
                                     const void* labels, void* loss,
                                     void* lse, void* part, int T_rows, int d,
                                     int V, int ldw, int n_split, int dtype,
                                     int tensor_cores, void* stream) {
  if (T_rows <= 0) return 0;
  const int tile = tensor_cores ? xtc::BN : BV;
  if (d <= 0 || V <= 0 || ldw < V || n_split < 1 ||
      n_split > (V + tile - 1) / tile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tensor_cores) {
    if (dtype != 1 || d % 8 || ldw % 8 || ((uintptr_t)h | (uintptr_t)W) % 16)
      return (int)cudaErrorInvalidValue;
    return xtc::launch(h, W, labels, loss, lse, part, T_rows, d, V, ldw,
                       n_split, st);
  }
  if (dtype == 0)
    return launch<float>(h, W, labels, loss, lse, part, T_rows, d, V, ldw,
                         n_split, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, W, labels, loss, lse, part, T_rows, d, V,
                                 ldw, n_split, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_xent_fwd_error_string(int code) {
  return xtc::error_string(code);
}
