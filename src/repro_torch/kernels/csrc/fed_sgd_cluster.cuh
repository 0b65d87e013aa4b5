// Shared parts of the two local-SGD kernels (fed_local_sgd.cu, MCLR, and
// fed_local_sgd_dense.cu, the tanh MLP), which run one thread-block cluster
// per client: the warp reductions, the cp.async fetch of a step's batch
// rows, the batch-row register chunks, and the cluster launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;   // the kernels' __launch_bounds__
constexpr int kMaxCluster = 8;     // portable cluster sizes only

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum of the nw warps' shares, in warp order (the loads first)
__device__ __forceinline__ float warps_sum(const float* v, int nw) {
  constexpr int kMaxWarps = kMaxThreads / 32;
  float t[kMaxWarps];
#pragma unroll
  for (int ww = 0; ww < kMaxWarps; ++ww) t[ww] = ww < nw ? v[ww] : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int ww = 0; ww < kMaxWarps; ++ww)
    if (ww < nw) s += t[ww];
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ inline long long align4(long long n) {
  return (n + 3) & ~3LL;
}

// The batch rows a thread holds in registers at once: B itself for the
// paper's B = 10, else the next of 4, 10, 16 (B > 16: chunks of 16).
__host__ __device__ inline int rows_in_registers(int B) {
  return B <= 4 ? 4 : B <= 10 ? 10 : 16;
}

// B rounded up to whole chunks: the batch-row buffers carry zero rows up
// to it, so that every chunk is loaded without a guard (a zero row adds
// an exact 0 to every sum it enters).
__host__ __device__ inline int padded_rows(int B) {
  const int rb = rows_in_registers(B);
  return (B + rb - 1) / rb * rb;
}

// Fetches step j's batch rows (this CTA's slice, columns [r0, r0 + nloc)
// of each, into xb[j & 1]), their labels (into ylab[j & 1]) and step
// j+1's indices (into sidx[(j + 1) & 1]) with cp.async, as thread t of tn;
// the indices of step j are in sidx[j & 1].  Indices are clamped into the
// shard, as the reference's gather clamps them.  16-byte copies where d
// and x allow them (R and r0 are multiples of 4), else 4-byte ones.
struct RowFetch {
  const float* xk;        // this client's rows [max_n, d]
  const int32_t* yk;      // [max_n]
  const int32_t* idxk;    // [max_iters, B]
  float* xb;              // [2][BP][R]
  int32_t* ylab;          // [2][B]
  int32_t* sidx;          // [2][B]
  int max_n, d, B, BP, R, r0, nloc, iters;
  bool vec;

  __device__ void operator()(int j, int t, int tn) const {
    const int32_t* sj = sidx + (j & 1) * B;
    float* dst = xb + (j & 1) * BP * R;
    if (vec) {
      const int nq4 = nloc >> 2;
      for (int g = t; g < B * nq4; g += tn) {
        const int bb = g / nq4, q = g - bb * nq4;
        const int r = min(max(sj[bb], 0), max_n - 1);
        cp_async16(dst + bb * R + 4 * q, xk + (long long)r * d + r0 + 4 * q);
      }
    } else {
      for (int g = t; g < B * nloc; g += tn) {
        const int bb = g / nloc, jj = g - bb * nloc;
        const int r = min(max(sj[bb], 0), max_n - 1);
        cp_async4(dst + bb * R + jj, xk + (long long)r * d + r0 + jj);
      }
    }
    for (int bb = t; bb < B; bb += tn) {
      const int r = min(max(sj[bb], 0), max_n - 1);
      cp_async4(ylab + (j & 1) * B + bb, yk + r);
      if (j + 1 < iters)
        cp_async4(sidx + ((j + 1) & 1) * B + bb,
                  idxk + (long long)(j + 1) * B + bb);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
};

// A launch of grid CTAs of nw warps in clusters of CS along x.
inline cudaLaunchConfig_t cluster_config(int grid, int CS, int nw,
                                         long long smem, void* stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of CS CTAs (nw warps, smem bytes each) of kernel fn can
// be resident at once; a negative value is a CUDA error code.
template <typename Kernel>
int max_active_clusters(Kernel fn, int CS, int nw, long long smem) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(CS, CS, nw, smem, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

// Launches fn on K clusters of CS CTAs; the CUDA error code, 0 on success.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel fn, int K, int CS, int nw, long long smem,
                    void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(K * CS, CS, nw, smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, fn, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
