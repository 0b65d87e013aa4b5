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
// What the design does about it: the TPU kernel ran one grid step per lane
// (one DMA each), which on this card would put K=10 blocks on 132 SMs.  Here
// the grid is (K, row chunks), so even K=10 puts hundreds of blocks in
// flight.  Each block loads its own start/length (the TPU kernel's scalar
// prefetch), copies its rows with 16-byte vector loads/stores when the row
// width and the base addresses allow it and 4-byte words otherwise, and
// writes its rows' labels and mask.  Element offsets are 64-bit.  Words are
// moved as uint32, so float32 and int32 features are copied bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void fed_gather_kernel(const uint32_t* __restrict__ flat_x,
                                  const int32_t* __restrict__ flat_y,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ ns,
                                  uint32_t* __restrict__ x_out,
                                  int32_t* __restrict__ y_out,
                                  float* __restrict__ mask_out,
                                  long long rows, int feat, int max_n,
                                  int rows_per_block) {
  const int k = blockIdx.x;
  const int r0 = blockIdx.y * rows_per_block;
  if (r0 >= max_n) return;
  const int r1 = min(r0 + rows_per_block, max_n);
  long long start = (long long)starts[k];
  const long long last = rows - (long long)max_n;
  if (start > last) start = last;   // memory-safety clamp, as the reference
  const int n = ns[k];

  const long long count = (long long)(r1 - r0) * feat;
  const uint32_t* src = flat_x + (start + r0) * (long long)feat;
  uint32_t* dst = x_out + ((long long)k * max_n + r0) * (long long)feat;
  const bool vec = (feat % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) % 16 == 0);
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < count / 4; i += blockDim.x)
      d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < count; i += blockDim.x)
      dst[i] = src[i];
  }
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const long long o = (long long)k * max_n + r;
    y_out[o] = flat_y[start + r];
    mask_out[o] = r < n ? 1.0f : 0.0f;
  }
}

extern "C" int fed_cohort_gather_launch(const void* flat_x, const void* flat_y,
                                        const void* starts, const void* ns,
                                        void* x_out, void* y_out,
                                        void* mask_out, long long rows,
                                        int feat, int K, int max_n,
                                        int rows_per_block, void* stream) {
  if (K <= 0 || max_n <= 0) return 0;
  const dim3 grid(K, (max_n + rows_per_block - 1) / rows_per_block);
  fed_gather_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)flat_x, (const int32_t*)flat_y,
      (const int32_t*)starts, (const int32_t*)ns, (uint32_t*)x_out,
      (int32_t*)y_out, (float*)mask_out, rows, feat, max_n, rows_per_block);
  return (int)cudaGetLastError();
}

extern "C" const char* fed_cohort_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
