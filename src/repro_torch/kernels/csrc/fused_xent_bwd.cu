// Backward of the fused softmax cross-entropy on Hopper's tensor cores
// (sm_90a), from the forward's saved log-sum-exp.
//
// Replaces: the recompute in the backward of the reference's
// fused_softmax_xent (src/repro/kernels/ops.py _fx_bwd, which takes
// jax.vjp of ref.softmax_xent; the reference has no backward kernel, so
// this computes that vjp).  Per row t of h [T, d] and W [d, V] (bf16) with
// labels [T], lse [T] and the loss cotangent g [T] (float32):
//   dlogits[t, v] = (exp(h[t] . W[:, v] - lse[t]) - [v == label[t]]) g[t]
//   dh = dlogits W^T,   dW = h^T dlogits
// with every product in float32, returned in bf16 (the leaves' dtype).
//
// What bounds it on this card: operations.  At Llama-3.2-3B's loss chunk
// (T = 1,024, d = 3,072, V = 128,256) the three products (the logits, dh
// and dW) are 3 x 2 T d V = 2.42 TFLOP of bf16 work against ~0.8 GB of h
// and W: 2.45 ms at 989 TFLOP/s.
//
// What the design does about it (a first, simple version: no persistent
// tiles, no ping-pong), three kernels on the tile mainloop of xent_tc.cuh:
// 1. xent_dlogits_tc_kernel, one block per (128-row tile, 128-column
//    vocabulary tile): the forward's product again (h K-major, W MN-major),
//    then dlogits from the accumulator fragments in float32, split into
//    hi = bf16(dlogits) and lo = bf16(dlogits - hi), both written as bf16
//    [T, V].  The float32 [T, V] logits and their softmax, which the plain
//    recompute builds, are never written.
// 2. xent_grad_gemm_tc_kernel<true>: dh = hi W^T + lo W^T, one block per
//    128 x 128 tile of dh, hi and lo read K-major as A, W read K-major as
//    B (its rows are dh's columns), K = V.
// 3. xent_grad_gemm_tc_kernel<false>: dW = h^T hi + h^T lo, one block per
//    128 x 128 tile of dW, A = h^T (a [d, T] copy the wrapper makes, 6 MB
//    at Llama's chunk, its rows padded to a multiple of 8 for TMA) read
//    K-major, hi and lo read MN-major as B, K = T.
// Both halves of a gradient go into one float32 accumulator, rounded to
// bf16 once at the end: hi + lo carries dlogits to ~2^-17 of its value, and
// bf16 x bf16 products are exact in float32, so the gradients differ from
// the reference's float32 dlogits by ~2^-17 relative before the final
// rounding (a single bf16 rounding of dlogits, ~2^-9, would not hold: the
// rows of dlogits sum to zero, so dh cancels).  Every output tile belongs
// to one block and is summed over K in a fixed order: no atomics, the same
// gradients run to run.  The wrapper (kernels/fused_xent.py) routes only
// bf16 with d % 8 == 0, V % 8 == 0 and 16-byte aligned pointers here (TMA's
// rules); float32 and the rest recompute through the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xent_tc.cuh"

namespace xtc {

constexpr int DL_NS = 4;        // dlogits ring: 128 KB, one block per SM
constexpr int GEMM_NS = 3;      // gradient products: 96 KB, two per SM

__global__ void __launch_bounds__(THREADS, 1)
xent_dlogits_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const int* __restrict__ labels,
                       const float* __restrict__ lse,
                       const float* __restrict__ g,
                       __nv_bfloat16* __restrict__ hi,
                       __nv_bfloat16* __restrict__ lo, int T_rows, int d,
                       int V) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  ring_init<DL_NS>(base);
  const int m0 = blockIdx.x * BM, v0 = blockIdx.y * BN;
  const int n_k = (d + BK - 1) / BK;
  const int tid = threadIdx.x;
  int it = 0;
  if (tid >= 256) {                             // producer warp
    if (tid == 256)
      produce<false, DL_NS>(base, &hmap, &wmap, m0, v0, V, n_k, it);
    return;
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[j][x] = 0.f;
  consume<false, DL_NS>(base, acc, wg, lane, n_k, false, it);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= T_rows) continue;
    const float lse_r = lse[r], g_r = g[r];
    const int lab = labels[r];
    __nv_bfloat16* hr = hi + (long long)r * V;
    __nv_bfloat16* lr = lo + (long long)r * V;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = v0 + 64 * j + 8 * n + cq;
        if (c >= V) continue;                   // V is even: c + 1 < V too
        float dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dl[e] = (expf(acc[j][4 * n + 2 * i + e] - lse_r) -
                   (c + e == lab ? 1.f : 0.f)) * g_r;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(dl[0], dl[1]);
        const __nv_bfloat162 l2 = __floats2bfloat162_rn(
            dl[0] - __low2float(h2), dl[1] - __high2float(h2));
        *reinterpret_cast<__nv_bfloat162*>(hr + c) = h2;
        *reinterpret_cast<__nv_bfloat162*>(lr + c) = l2;
      }
  }
}

// C [M, N] bf16 = A1 B1 + A2 B2 in one float32 accumulator, rounded once;
// one block per 128 x 128 tile of C, K = the shared depth.
template <bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS, 2)
xent_grad_gemm_tc_kernel(const __grid_constant__ CUtensorMap a1map,
                         const __grid_constant__ CUtensorMap a2map,
                         const __grid_constant__ CUtensorMap b1map,
                         const __grid_constant__ CUtensorMap b2map,
                         __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  ring_init<GEMM_NS>(base);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_k = (K + BK - 1) / BK;
  const int tid = threadIdx.x;
  int it = 0;
  if (tid >= 256) {                             // producer warp
    if (tid == 256) {
      produce<B_KMAJOR, GEMM_NS>(base, &a1map, &b1map, m0, n0, N, n_k, it);
      produce<B_KMAJOR, GEMM_NS>(base, &a2map, &b2map, m0, n0, N, n_k, it);
    }
    return;
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[j][x] = 0.f;
  consume<B_KMAJOR, GEMM_NS>(base, acc, wg, lane, n_k, false, it);
  consume<B_KMAJOR, GEMM_NS>(base, acc, wg, lane, n_k, true, it);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= M) continue;
    __nv_bfloat16* cr = C + (long long)r * N;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n0 + 64 * j + 8 * n + cq;
        if (c < N)                              // N is even: c + 1 < N too
          *reinterpret_cast<uint32_t*>(cr + c) =
              pack_bf16(acc[j][4 * n + 2 * i], acc[j][4 * n + 2 * i + 1]);
      }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace xtc

// h [T, d], W [d, V] bf16 (d % 8 == 0, V % 8 == 0, 16-byte aligned);
// hT [d, Tp] bf16, h transposed with its rows zero-padded to Tp (a multiple
// of 8 >= T); labels int32 [T]; lse, g float32 [T]; hi, lo bf16 [T, V]
// scratch; dh [T, d] and dW [d, V] bf16 out.  Launches the dlogits kernel,
// then the dh and dW products, on ``stream``.
extern "C" int fused_xent_bwd_launch(const void* h, const void* hT,
                                     const void* W, const void* labels,
                                     const void* lse, const void* g, void* hi,
                                     void* lo, void* dh, void* dW, int T_rows,
                                     int Tp, int d, int V, void* stream) {
  using namespace xtc;
  if (T_rows <= 0) return 0;
  if (d <= 0 || V <= 0 || d % 8 || V % 8 || Tp % 8 || Tp < T_rows ||
      ((uintptr_t)h | (uintptr_t)hT | (uintptr_t)W | (uintptr_t)hi |
       (uintptr_t)lo) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap h_a, w_mn, hi_a, lo_a, w_k, hT_a, hi_mn, lo_mn;
  int err = make_map_2d(&h_a, h, T_rows, d, BM);
  if (!err) err = make_map_2d(&w_mn, W, d, V, BK);
  if (!err) err = make_map_2d(&hi_a, hi, T_rows, V, BM);
  if (!err) err = make_map_2d(&lo_a, lo, T_rows, V, BM);
  if (!err) err = make_map_2d(&w_k, W, d, V, BN);
  if (!err) err = make_map_2d(&hT_a, hT, d, Tp, BM);
  if (!err) err = make_map_2d(&hi_mn, hi, T_rows, V, BK);
  if (!err) err = make_map_2d(&lo_mn, lo, T_rows, V, BK);
  if (err) return err;
  if ((err = set_smem(xent_dlogits_tc_kernel, Ring<DL_NS>::ALLOC)) ||
      (err = set_smem(xent_grad_gemm_tc_kernel<true>,
                      Ring<GEMM_NS>::ALLOC)) ||
      (err = set_smem(xent_grad_gemm_tc_kernel<false>,
                      Ring<GEMM_NS>::ALLOC)))
    return err;
  const int n_rt = (T_rows + BM - 1) / BM;
  xent_dlogits_tc_kernel<<<dim3(n_rt, (V + BN - 1) / BN), THREADS,
                           Ring<DL_NS>::ALLOC, st>>>(
      h_a, w_mn, (const int*)labels, (const float*)lse, (const float*)g,
      (__nv_bfloat16*)hi, (__nv_bfloat16*)lo, T_rows, d, V);
  if ((err = (int)cudaGetLastError())) return err;
  // dh [T, d] = hi W^T + lo W^T: A [T, V] K-major, B = W as [d, V] K-major
  xent_grad_gemm_tc_kernel<true><<<dim3(n_rt, (d + BN - 1) / BN), THREADS,
                                    Ring<GEMM_NS>::ALLOC, st>>>(
      hi_a, lo_a, w_k, w_k, (__nv_bfloat16*)dh, T_rows, d, V);
  if ((err = (int)cudaGetLastError())) return err;
  // dW [d, V] = h^T hi + h^T lo: A = hT [d, Tp] K-major, B [T, V] MN-major
  xent_grad_gemm_tc_kernel<false><<<dim3((d + BM - 1) / BM,
                                         (V + BN - 1) / BN),
                                    THREADS, Ring<GEMM_NS>::ALLOC, st>>>(
      hT_a, hT_a, hi_mn, lo_mn, (__nv_bfloat16*)dW, d, V, T_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_xent_bwd_error_string(int code) {
  return xtc::error_string(code);
}
