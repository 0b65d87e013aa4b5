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
// What the design does about it: four kernels, the three products on the
// tile mainloop of xent_tc.cuh (128 x 256 tiles, one m64n256 wgmma per
// warpgroup and k16 slice), each a persistent grid of one block per SM
// that walks a static schedule of tiles, so that the producer warp loads
// the next tile's first stages while the consumers run the last one's
// epilogue; dW's bf16 tiles (0.79 GB at Llama's chunk) leave through
// shared memory by TMA stores that drain while the next tile's products
// run:
// 1. xent_dlogits_tc_kernel, tiles (128 rows, 256 vocabulary columns): the
//    forward's product again (h K-major, W MN-major), then dlogits from
//    the accumulator fragments in float32, split into hi = bf16(dlogits)
//    and lo = bf16(dlogits - hi), both written as bf16 [T, V] (rows ldg
//    apart).  The float32 [T, V] logits and their softmax, which the plain
//    recompute builds, are never written.
// 2. xent_dh_tc_kernel: dh = hi W^T + lo W^T, tiles (128 rows of dh, 256
//    of its columns) with K = V split into n_split ranges (split-K: the
//    8 x 12 tiles of Llama's chunk would fill 96 of 132 SMs), each stage
//    holding a tile of hi and one of lo against one tile of W (W read
//    K-major: its rows are dh's columns), both products into one float32
//    accumulator; each split writes its float32 partial tile to a
//    workspace [n_split, T, d].
// 3. xent_dh_reduce_kernel: dh = bf16(sum of the splits' partials), the
//    splits summed in order.
// 4. xent_dw_tc_kernel: dW = h^T hi + h^T lo, tiles (128 rows of dW, 256
//    of its columns), A = h^T (a [d, Tp] copy the wrapper makes, 6 MB at
//    Llama's chunk, its rows padded to a multiple of 8 for TMA) read
//    K-major, hi then lo read MN-major as B, K = T each, taken by the
//    consumers as one run of 2 ceil(T / 64) stages.
// Both halves of a gradient go into one float32 accumulator, rounded to
// bf16 once at the end: hi + lo carries dlogits to ~2^-17 of its value, and
// bf16 x bf16 products are exact in float32, so the gradients differ from
// the reference's float32 dlogits by ~2^-17 relative before the final
// rounding (a single bf16 rounding of dlogits, ~2^-9, would not hold: the
// rows of dlogits sum to zero, so dh cancels).  Every output tile (every
// split's partial of dh) belongs to one block and is summed over its K in a
// fixed order, and the splits are summed in a fixed order: no atomics, the
// same gradients run to run.
//
// W may be the [:, :V] view of a [d, ceil8(V)] buffer (ldw its row pitch),
// and hi, lo and dW are [*, ldg] buffers with ldg = ceil8(V), so an odd
// vocabulary takes this route too: TMA reads nothing at or past V (zeros
// come in their place) and writes nothing there but the second half of the
// dlogits epilogue's last bf16 pair, a pad column of hi and lo.  The wrapper (kernels/fused_xent.py) routes bf16 with
// d % 8 == 0, a row pitch of W that is a multiple of 8 and 16-byte aligned
// pointers here (TMA's rules); float32 and the rest recompute through the
// plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xent_tc.cuh"

namespace xtc {

constexpr int DL_NS = 4;        // dlogits ring: 4 x 48 KB
constexpr int DH_NS = 3;        // dh ring: 3 x 64 KB (hi, lo and W)
constexpr int DW_NS = 3;        // dW ring: 3 x 48 KB, then the staging
// dW's epilogue staging: four 128 x 64 bf16 boxes (64 KB)
constexpr int DW_EPI_BYTES = 4 * EPI_BOX_BYTES;

// hi and lo are stored from registers, a bf16 pair a thread and column
// pair: staging both tiles (128 KB) would leave the ring 2 stages, and a
// 3-stage ring with half the staging measured slower.
__global__ void __launch_bounds__(THREADS, 1)
xent_dlogits_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const int* __restrict__ labels,
                       const float* __restrict__ lse,
                       const float* __restrict__ g,
                       __nv_bfloat16* __restrict__ hi,
                       __nv_bfloat16* __restrict__ lo, int T_rows, int d,
                       int V, int ldg) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  ring_init<1, DL_NS>(base);
  const int n_mt = (T_rows + BM - 1) / BM;
  const int n_items = n_mt * ((V + BN - 1) / BN);
  const int n_k = (d + BK - 1) / BK;
  const int tid = threadIdx.x;
  int it = 0;
  if (tid >= 256) {                             // producer warp
    if (tid == 256)
      for (int item = blockIdx.x; item < n_items; item += gridDim.x)
        produce<false, 1, DL_NS>(base, &hmap, &hmap, &wmap,
                                 (item % n_mt) * BM, (item / n_mt) * BN, V,
                                 0, n_k, it);
    return;
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int cq = 2 * (lane & 3);
  float acc[ACC];
  zero(acc);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int m0 = (item % n_mt) * BM, v0 = (item / n_mt) * BN;
    consume<false, 1, DL_NS>(base, acc, wg, lane, n_k, false, it);
    const int r0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= T_rows) continue;
      const float lse_r = lse[r], g_r = g[r];
      const int lab = labels[r];
      __nv_bfloat16* hr = hi + (long long)r * ldg;
      __nv_bfloat16* lr = lo + (long long)r * ldg;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int c = v0 + 8 * n + cq;
        if (c >= V) continue;         // c + 1 < ldg: ldg is even and >= V
        float dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dl[e] = c + e < V ? (expf(acc[4 * n + 2 * i + e] - lse_r) -
                               (c + e == lab ? 1.f : 0.f)) * g_r
                            : 0.f;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(dl[0], dl[1]);
        const __nv_bfloat162 l2 = __floats2bfloat162_rn(
            dl[0] - __low2float(h2), dl[1] - __high2float(h2));
        *reinterpret_cast<__nv_bfloat162*>(hr + c) = h2;
        *reinterpret_cast<__nv_bfloat162*>(lr + c) = l2;
      }
    }
  }
}

// ws[split] [T, d] float32 = (hi + lo) W^T over the split's range of V.
// Items (split, row tile, column tile), the row tile fastest.
__global__ void __launch_bounds__(THREADS, 1)
xent_dh_tc_kernel(const __grid_constant__ CUtensorMap himap,
                  const __grid_constant__ CUtensorMap lomap,
                  const __grid_constant__ CUtensorMap wmap,
                  float* __restrict__ ws, int T_rows, int d, int V,
                  int n_split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  ring_init<2, DH_NS>(base);
  const int n_mt = (T_rows + BM - 1) / BM;
  const int n_tiles = n_mt * ((d + BN - 1) / BN);
  const int n_items = n_tiles * n_split;
  const int n_k = (V + BK - 1) / BK;
  const int tid = threadIdx.x;
  int it = 0;
  if (tid >= 256) {                             // producer warp
    if (tid == 256)
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int split = item / n_tiles, tile = item % n_tiles;
        const int k_begin = (int)((long long)n_k * split / n_split);
        const int k_end = (int)((long long)n_k * (split + 1) / n_split);
        produce<true, 2, DH_NS>(base, &himap, &lomap, &wmap,
                                (tile % n_mt) * BM, (tile / n_mt) * BN, d,
                                k_begin, k_end - k_begin, it);
      }
    return;
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int cq = 2 * (lane & 3);
  float acc[ACC];
  zero(acc);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int split = item / n_tiles, tile = item % n_tiles;
    const int k_begin = (int)((long long)n_k * split / n_split);
    const int k_end = (int)((long long)n_k * (split + 1) / n_split);
    const int m0 = (tile % n_mt) * BM, n0 = (tile / n_mt) * BN;
    consume<true, 2, DH_NS>(base, acc, wg, lane, k_end - k_begin, false, it);
    float* part = ws + (long long)split * T_rows * d;
    const int r0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= T_rows) continue;
      float* pr = part + (long long)r * d;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int c = n0 + 8 * n + cq;
        if (c < d)                              // d is even: c + 1 < d too
          *reinterpret_cast<float2*>(pr + c) =
              make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
      }
    }
  }
}

// dh = bf16(ws[0] + ws[1] + ... + ws[n_split - 1]), four elements a thread
__global__ void xent_dh_reduce_kernel(const float* __restrict__ ws,
                                      __nv_bfloat16* __restrict__ dh,
                                      long long n, int n_split) {
  const long long i =
      4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int k = 1; k < n_split; ++k) {
    const float4 p = *reinterpret_cast<const float4*>(ws + k * n + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  uint2 out;
  out.x = pack_bf16(s.x, s.y);
  out.y = pack_bf16(s.z, s.w);
  *reinterpret_cast<uint2*>(dh + i) = out;
}

// dW [d, V] bf16 = h^T hi + h^T lo in one float32 accumulator, rounded
// once and stored through the staging by TMA (dwmap: [d, V], rows ldg
// apart).  Items (row tile, column tile), the row tile fastest, so the
// blocks in flight share the column tiles of hi and lo.
__global__ void __launch_bounds__(THREADS, 1)
xent_dw_tc_kernel(const __grid_constant__ CUtensorMap htmap,
                  const __grid_constant__ CUtensorMap himap,
                  const __grid_constant__ CUtensorMap lomap,
                  const __grid_constant__ CUtensorMap dwmap, int T_rows,
                  int d, int V) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ring_base(smem_raw);
  ring_init<1, DW_NS>(base);
  const uint32_t epi = base + Ring<1, DW_NS>::EPI_OFF;
  const int n_mt = (d + BM - 1) / BM;
  const int n_items = n_mt * ((V + BN - 1) / BN);
  const int n_k = (T_rows + BK - 1) / BK;
  const int tid = threadIdx.x;
  int it = 0;
  if (tid >= 256) {                             // producer warp
    if (tid == 256)
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int m0 = (item % n_mt) * BM, n0 = (item / n_mt) * BN;
        produce<false, 1, DW_NS>(base, &htmap, &htmap, &himap, m0, n0, V, 0,
                                 n_k, it);
        produce<false, 1, DW_NS>(base, &htmap, &htmap, &lomap, m0, n0, V, 0,
                                 n_k, it);
      }
    return;
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int cq = 2 * (lane & 3);
  const int rt = 64 * wg + 16 * warp + (lane >> 2);   // row in the tile
  float acc[ACC];
  zero(acc);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int m0 = (item % n_mt) * BM, n0 = (item / n_mt) * BN;
    // the hi stages, then the lo stages, in one pass of the ring: no drain
    // of the wgmma pipeline between them
    consume<false, 1, DW_NS>(base, acc, wg, lane, 2 * n_k, false, it);
    if (tid == 0) bulk_wait_read();     // the staging's last stores read it
    consumers_sync();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        st_shared_u32(epi + (n >> 3) * EPI_BOX_BYTES +
                          box_offset(rt + 8 * i, (8 * n + cq) & 63),
                      pack_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]));
    fence_async_shared();
    consumers_sync();
    if (tid == 0) {
      for (int q = 0; q < BN / 64 && n0 + 64 * q < V; ++q)
        tma_store_2d(&dwmap, epi + q * EPI_BOX_BYTES, n0 + 64 * q, m0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace xtc

// h [T, d] bf16 (d % 8 == 0); W [d, V] bf16 with rows ldw apart (ldw % 8
// == 0, ldw >= V); hT [d, Tp] bf16, h transposed with its rows zero-padded
// to Tp (a multiple of 8 >= T); labels int32 [T]; lse, g float32 [T]; hi,
// lo bf16 [T, ldg] scratch and dW bf16 [d, ldg] out (ldg % 8 == 0,
// ldg >= V; dW's columns at and past V are not written); ws float32
// [n_split, T, d] scratch, n_split in [1, ceil(V / 64)]; dh [T, d] bf16
// out.  Every pointer 16-byte aligned.  Launches the dlogits kernel, the dh
// product and its reduction, then the dW product, on ``stream``.
extern "C" int fused_xent_bwd_launch(const void* h, const void* hT,
                                     const void* W, const void* labels,
                                     const void* lse, const void* g, void* hi,
                                     void* lo, void* ws, void* dh, void* dW,
                                     int T_rows, int Tp, int d, int V,
                                     int ldw, int ldg, int n_split,
                                     void* stream) {
  using namespace xtc;
  if (T_rows <= 0) return 0;
  if (d <= 0 || V <= 0 || d % 8 || ldw % 8 || ldw < V || ldg % 8 ||
      ldg < V || Tp % 8 || Tp < T_rows || n_split < 1 ||
      n_split > (V + BK - 1) / BK ||
      ((uintptr_t)h | (uintptr_t)hT | (uintptr_t)W | (uintptr_t)hi |
       (uintptr_t)lo | (uintptr_t)ws | (uintptr_t)dh | (uintptr_t)dW) % 16)
    return (int)cudaErrorInvalidValue;
  const int n_sm = sm_count();
  if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap h_a, w_mn, hi_a, lo_a, w_k, hT_a, hi_mn, lo_mn, dw_st;
  int err = make_map_2d(&h_a, h, T_rows, d, d, BM);
  if (!err) err = make_map_2d(&w_mn, W, d, V, ldw, BK);
  if (!err) err = make_map_2d(&hi_a, hi, T_rows, V, ldg, BM);
  if (!err) err = make_map_2d(&lo_a, lo, T_rows, V, ldg, BM);
  if (!err) err = make_map_2d(&w_k, W, d, V, ldw, BN);
  if (!err) err = make_map_2d(&hT_a, hT, d, Tp, Tp, BM);
  if (!err) err = make_map_2d(&hi_mn, hi, T_rows, V, ldg, BK);
  if (!err) err = make_map_2d(&lo_mn, lo, T_rows, V, ldg, BK);
  if (!err) err = make_map_2d(&dw_st, dW, d, V, ldg, BM);
  if (err) return err;
  const int dl_smem = Ring<1, DL_NS>::alloc(0);
  const int dh_smem = Ring<2, DH_NS>::alloc(0);
  const int dw_smem = Ring<1, DW_NS>::alloc(DW_EPI_BYTES);
  if ((err = set_smem(xent_dlogits_tc_kernel, dl_smem)) ||
      (err = set_smem(xent_dh_tc_kernel, dh_smem)) ||
      (err = set_smem(xent_dw_tc_kernel, dw_smem)))
    return err;
  auto grid = [n_sm](long long items) {
    return (int)(items < n_sm ? items : n_sm);
  };
  const long long n_mt = (T_rows + BM - 1) / BM;
  const long long n_vt = (V + BN - 1) / BN;
  xent_dlogits_tc_kernel<<<grid(n_mt * n_vt), THREADS, dl_smem, st>>>(
      h_a, w_mn, (const int*)labels, (const float*)lse, (const float*)g,
      (__nv_bfloat16*)hi, (__nv_bfloat16*)lo, T_rows, d, V, ldg);
  if ((err = (int)cudaGetLastError())) return err;
  // ws [n_split, T, d] = (hi + lo) W^T: A [T, V] K-major, B = W as [d, V]
  // K-major; then dh = the splits' sum
  xent_dh_tc_kernel<<<grid(n_mt * ((d + BN - 1) / BN) * n_split), THREADS,
                      dh_smem, st>>>(
      hi_a, lo_a, w_k, (float*)ws, T_rows, d, V, n_split);
  if ((err = (int)cudaGetLastError())) return err;
  const long long n = (long long)T_rows * d;
  xent_dh_reduce_kernel<<<(int)((n / 4 + 255) / 256), 256, 0, st>>>(
      (const float*)ws, (__nv_bfloat16*)dh, n, n_split);
  if ((err = (int)cudaGetLastError())) return err;
  // dW [d, V] = h^T hi + h^T lo: A = hT [d, Tp] K-major, B [T, V] MN-major
  xent_dw_tc_kernel<<<grid(((d + BM - 1) / BM) * n_vt), THREADS, dw_smem,
                      st>>>(hT_a, hi_mn, lo_mn, dw_st, T_rows, d, V);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_xent_bwd_error_string(int code) {
  return xtc::error_string(code);
}
