// Cohort gather for the federated round, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fed_gather.py fed_cohort_gather_fwd
// (_gather_kernel, pallas_call at :86).  For each cohort lane k it copies
// rows [start_k, start_k + max_n) of the packed federation's flat x / y and
// writes the validity mask pos < n_k; start_k is clamped to rows - max_n.
//
// What bounds it on this card: memory bandwidth.  It is pure data movement:
// each call reads K * max_n rows of `feat` 32-bit words plus the labels and
// writes them back out with the mask.  At FEMNIST paper scale (K=10,
// max_n=400, feat=784) that is ~25 MB, ~7.5 us at 3.35 TB/s.
//
// What the design does about it: each lane's rows are one contiguous span
// of max_n * feat words, in the source and in the output.  The spans are
// cut into 8 KB tiles (THREADS * UNROLL 16-byte vectors); a thread issues
// all UNROLL of its loads before any of its stores, so every thread keeps
// UNROLL loads in flight instead of one; consecutive tiles belong to
// different lanes, so the lanes' spans are read side by side; and the grid
// is sized to the card (at most 16 resident 128-thread blocks per SM,
// striding over the tiles), so at FEMNIST scale the whole ~12.5 MB read is
// requested in one wave.  (Measured against 256-thread blocks, 8 loads
// per thread, lane-major tile order and a TMA bulk-copy ring, this was the
// fastest; see PERF.md.)
// Rows go as 16-byte vectors when the row width and the base addresses
// allow it and as 4-byte words otherwise.  Each tile's block also writes a
// share of its lane's labels and mask.  Element offsets are 64-bit.  Words
// are moved as uint32, so float32 and int32 features are copied bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;                 // loads in flight per thread
constexpr int BLOCKS_PER_SM = 16;         // 2048 threads: the SM's limit
constexpr long long TILE = (long long)THREADS * UNROLL;

template <typename W>
__global__ void __launch_bounds__(THREADS)
fed_gather_kernel(const uint32_t* __restrict__ flat_x,
                  const int32_t* __restrict__ flat_y,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ ns,
                  uint32_t* __restrict__ x_out, int32_t* __restrict__ y_out,
                  float* __restrict__ mask_out, long long rows, int feat,
                  int K, int max_n, long long tiles_per_lane) {
  constexpr int WORDS = sizeof(W) / 4;
  const long long span = (long long)max_n * feat / WORDS;   // in W
  const long long last = rows - (long long)max_n;
  for (long long tile = blockIdx.x; tile < (long long)K * tiles_per_lane;
       tile += gridDim.x) {
    const int k = (int)(tile % K);          // consecutive tiles: other lanes
    const long long part = tile / K;
    long long start = (long long)starts[k];
    if (start > last) start = last;   // memory-safety clamp, as the reference
    const W* src = reinterpret_cast<const W*>(flat_x + start * feat);
    W* dst = reinterpret_cast<W*>(x_out + (long long)k * max_n * feat);
    const long long i0 = part * TILE + threadIdx.x;
    W v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = i0 + (long long)u * THREADS;
      if (i < span) v[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = i0 + (long long)u * THREADS;
      if (i < span) dst[i] = v[u];
    }
    const int n = ns[k];
    for (long long r = part * THREADS + threadIdx.x; r < max_n;
         r += tiles_per_lane * THREADS) {
      const long long o = (long long)k * max_n + r;
      y_out[o] = flat_y[start + r];
      mask_out[o] = r < n ? 1.0f : 0.0f;
    }
  }
}

}  // namespace

extern "C" int fed_cohort_gather_launch(const void* flat_x, const void* flat_y,
                                        const void* starts, const void* ns,
                                        void* x_out, void* y_out,
                                        void* mask_out, long long rows,
                                        int feat, int K, int max_n,
                                        int n_sm, void* stream) {
  if (K <= 0 || max_n <= 0) return 0;
  if (n_sm <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = (feat % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(flat_x) |
                     reinterpret_cast<uintptr_t>(x_out)) % 16 == 0);
  const long long span = (long long)max_n * feat / (vec ? 4 : 1);
  const long long per_lane = (span + TILE - 1) / TILE;
  const long long tiles = per_lane * K;
  const long long cap = (long long)n_sm * BLOCKS_PER_SM;
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    fed_gather_kernel<uint4><<<grid, THREADS, 0, st>>>(
        (const uint32_t*)flat_x, (const int32_t*)flat_y,
        (const int32_t*)starts, (const int32_t*)ns, (uint32_t*)x_out,
        (int32_t*)y_out, (float*)mask_out, rows, feat, K, max_n, per_lane);
  else
    fed_gather_kernel<uint32_t><<<grid, THREADS, 0, st>>>(
        (const uint32_t*)flat_x, (const int32_t*)flat_y,
        (const int32_t*)starts, (const int32_t*)ns, (uint32_t*)x_out,
        (int32_t*)y_out, (float*)mask_out, rows, feat, K, max_n, per_lane);
  return (int)cudaGetLastError();
}

extern "C" const char* fed_cohort_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
