// Top-k + int8 upload compression for the federated round, hand-written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fed_compress.py fed_compress_topk_q8_fwd
// (_compress_kernel, pallas_call at :93).  Per client row e [P] (the
// error-feedback delta) it writes, bit for bit as the reference:
//   scale = max|e| * float32(1/127)          (an IEEE multiply)
//   thr   = sort(|e|)[P - k]                 (the k-th largest magnitude)
//   mask  = (|e| > thr) | the EARLIEST (|e| == thr) ties, exactly k of them
//   q     = clip(round_half_even(e / scale), -127, 127) on the mask, else 0
// k <= 0 sends nothing, k >= P keeps every coordinate, and a row whose scale
// is not > 0 (a zero row) quantises to all zeros.
//
// What bounds it on this card: memory.  The work is a few compares per
// coordinate; the call must read K * P floats and write K * P int8 plus K
// scales (2.6 MB at K=10 and the FEMNIST MLP's P = 51,930: ~0.8 us at
// 3.35 TB/s).
//
// What the design does about it: the TPU kernel sorted the row in VMEM.
// Here the threshold is found without a sort, by radix select on the
// uint32 bit pattern of |e| (non-negative floats order like their bits):
// four passes of a 256-bin histogram, from the top byte down, each keeping
// the bin that holds rank P - k and narrowing the prefix, give exactly
// sort(|e|)[P - k] and, on the way, how many coordinates lie below it.  The
// earliest ties come from a block-wide exclusive scan of per-thread tie
// counts, each thread owning a contiguous index chunk and walking it in
// index order.  One block of 1024 threads per row; the row stays in global
// memory and its repeated passes are served by the 50 MB L2 (a FEMNIST MLP
// row is 208 KB).  The histograms count with warp-aggregated shared-memory
// integer atomics, which are exact in any order, so the result is
// deterministic.
//
// Division is __fdiv_rn and rounding rintf (half to even, as jnp.round);
// the build has no --use_fast_math.  Rows with a NaN are outside the
// contract (the reference's sort and compares order NaN differently).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

__device__ __forceinline__ int8_t quantise(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)(int)r;
}

// inclusive prefix sum of v over the block, in thread order; `warp_tot` is
// kWarps ints of shared scratch.  Every thread must call it.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_tot[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  const int base = warp > 0 ? warp_tot[warp - 1] : 0;
  __syncthreads();   // warp_tot may be reused by the caller
  return v + base;
}

__global__ void __launch_bounds__(kThreads)
fed_compress_kernel(const float* __restrict__ ef, int8_t* __restrict__ q_out,
                    float* __restrict__ scale_out, int P, int k) {
  __shared__ unsigned hist[256];
  __shared__ int warp_scratch[kWarps];
  __shared__ unsigned sel_bin, sel_below;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* e = ef + (long long)blockIdx.x * P;
  int8_t* q = q_out + (long long)blockIdx.x * P;

  // 1. amax over |e| (an exact max in any order) and the scale
  unsigned m = 0;
  for (int i = tid; i < P; i += nt) m = max(m, abs_bits(e[i]));
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) warp_scratch[warp] = (int)m;
  __syncthreads();
  if (warp == 0) {
    m = __reduce_max_sync(0xffffffffu, (unsigned)warp_scratch[lane]);
    if (lane == 0) sel_bin = m;
  }
  __syncthreads();
  const float scale = __fmul_rn(__uint_as_float(sel_bin), 1.0f / 127.0f);
  if (tid == 0) scale_out[blockIdx.x] = scale;

  if (!(scale > 0.0f) || k <= 0) {
    for (int i = tid; i < P; i += nt) q[i] = 0;
    return;
  }
  if (k >= P) {
    for (int i = tid; i < P; i += nt) q[i] = quantise(e[i], scale);
    return;
  }

  // 2. radix select of rank P - k (ascending) over the bits of |e|
  unsigned prefix = 0, known = 0;    // fixed high bits and their mask
  unsigned rank = (unsigned)(P - k);
  unsigned below = 0, n_eq = 0;      // coordinates < thr, == thr
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += nt) hist[b] = 0;
    __syncthreads();
    // warp-aggregated: lanes with the same bin add once (most |e| share a
    // few exponents, so the top byte's bins are hot)
    for (int base = 0; base < P; base += nt) {
      const int i = base + tid;
      unsigned key = 0xffffffffu;    // no bin
      if (i < P) {
        const unsigned u = abs_bits(e[i]);
        if ((u & known) == prefix) key = (u >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key != 0xffffffffu && lane == __ffs(peers) - 1)
        atomicAdd(&hist[key], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (warp == 0) {   // lane l scans bins 8l .. 8l+7
      unsigned c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[lane * 8 + j];
        s += c[j];
      }
      unsigned incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      unsigned run = incl - s;
      if (run <= rank && rank < incl) {   // exactly one lane
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run <= rank && rank < run + c[j]) {
            sel_bin = lane * 8 + j;
            sel_below = run;
          }
          run += c[j];
        }
      }
    }
    __syncthreads();
    const unsigned bin = sel_bin;
    rank -= sel_below;
    below += sel_below;
    n_eq = hist[bin];
    prefix |= bin << shift;
    known |= 255u << shift;
    __syncthreads();   // hist and sel_* are rewritten by the next pass
  }
  const unsigned thr = prefix;
  // need = k - count(|e| > thr) >= 1 ties to take, earliest first
  const int need = k - (P - (int)below - (int)n_eq);

  // 3. mask + quantise: contiguous chunks, ties counted in index order
  const int chunk = (P + nt - 1) / nt;
  const int i0 = min(tid * chunk, P), i1 = min(i0 + chunk, P);
  int my_eq = 0;
  for (int i = i0; i < i1; ++i) my_eq += abs_bits(e[i]) == thr;
  int seen = block_inclusive_scan(my_eq, warp_scratch) - my_eq;
  for (int i = i0; i < i1; ++i) {
    const float v = e[i];
    const unsigned u = abs_bits(v);
    bool take = u > thr;
    if (u == thr) take = ++seen <= need;
    q[i] = take ? quantise(v, scale) : (int8_t)0;
  }
}

extern "C" int fed_compress_topk_q8_launch(const void* ef, void* q_out,
                                           void* scale_out, int K, int P,
                                           int k, void* stream) {
  if (K <= 0 || P <= 0) return 0;
  fed_compress_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ef, (int8_t*)q_out, (float*)scale_out, P, k);
  return (int)cudaGetLastError();
}

extern "C" const char* fed_compress_topk_q8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
