// Top-k + int8 upload compression for the federated round, hand-written for
// Hopper (sm_90a), one thread-block cluster per client row.
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
// 3.35 TB/s).  At that size what costs is latency: the passes over the row
// and the barriers between them.
//
// What the design does about it: the TPU kernel sorted the row in VMEM.
// Here the threshold is found without a sort, by radix select on the
// uint32 bit pattern of |e| (non-negative floats order like their bits).
//   - One cluster of CS CTAs (CS in 1, 2, 4, 8) per row; rank r owns the
//     contiguous slice [r S, r S + S) of the row.  On the resident route it
//     loads the slice ONCE into shared memory with cp.async (16 bytes where
//     the row's alignment allows) and every later sweep reads shared
//     memory; the streamed route (rows over CS x the per-CTA budget)
//     re-reads its slice from L2/HBM each sweep, several groups in flight
//     a thread.
//   - Three passes of 12 + 12 + 7 bits, from the top (bits 30-19, 18-7,
//     6-0).  Each CTA counts its slice into a shared histogram with
//     integer atomics (exact in any order), and the histogram's 64 chunk
//     sums beside it; amax rides on pass 0's sweep.  After ONE cluster
//     barrier a pass, warp 0 of every CTA reads the ranks' chunk sums
//     through distributed shared memory, summed in rank order, finds the
//     chunk that holds rank P - k, then reads that chunk's 64 bins of every
//     rank and finds the bin: every CTA gets the same answer, with no
//     second barrier.  The histograms are double-buffered, so that a pass
//     never rewrites what the cluster may still read.
//   - Ties: the last pass's histogram holds each CTA's count of |e| ==
//     thr, so a CTA's share of the earliest ties follows from the lower
//     ranks' counts, read remotely.  Only the CTA that holds the cut-off
//     walks its slice in index order (a block scan per 2,048
//     coordinates); the others take all or none of theirs.
//   - Quantise from shared memory, four coordinates a thread, int8 stored
//     four at a time where aligned.  The slice's start in shared memory is
//     padded so that shared float4 groups line up with q's 4-byte words.
//   - The last remote read is followed by barrier.cluster.arrive and the
//     CTA waits only before it exits, so the last sweeps hide the wait.
// No float atomics and fixed orders: two launches give the same bits.
//
// Division is __fdiv_rn and rounding rintf (half to even, as jnp.round);
// the build has no --use_fast_math.  Rows with a NaN are outside the
// contract (the reference's sort and compares order NaN differently).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 4096;          // the widest pass: 12 bits
constexpr int kChunk = 64;           // bins per chunk of the two-level find
constexpr int kChunks = kBins / kChunk;
constexpr int kPasses = 3;
constexpr int kMaxCluster = 8;       // portable cluster sizes only
constexpr int kStreamGroups = 4;     // float4 groups in flight a thread,
                                     // streamed route

// pass p counts bits [shift, shift + log2(bins)) of |e|'s pattern (bit 31,
// the sign, is 0): bits 30-19, 18-7, 6-0
__host__ __device__ constexpr int pass_shift(int p) {
  return p == 0 ? 19 : p == 1 ? 7 : 0;
}
__host__ __device__ constexpr int pass_bins(int p) {
  return p == 2 ? 128 : kBins;
}

// The CTA's bookkeeping, at the start of its dynamic shared memory.
struct Ctl {
  unsigned amax;                          // max |e| bits (read remotely)
  unsigned sel_c, sel_base, sel_bin, sel_below, sel_eq, tie_base, unused;
  unsigned ranks[kMaxCluster];            // the ranks' amax
  unsigned csum[2][kChunks];              // chunk sums, by pass parity
                                          // (read remotely)
  unsigned warp_tot[kWarps];
};
static_assert(sizeof(Ctl) % 16 == 0, "Ctl keeps the histograms aligned");

// Dynamic shared memory: Ctl, two histograms [kBins] (pass p uses p & 1,
// so a pass never rewrites what the cluster may still read), and on the
// resident route the slice [S + 4] (S a multiple of 4; up to 3 floats of
// alignment padding in front of it).
__host__ __device__ inline long long smem_layout_bytes(int S, bool resident) {
  return (long long)sizeof(Ctl) + 8LL * kBins +
         (resident ? 4LL * (S + 4) : 0);
}

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

__device__ __forceinline__ int8_t quantise(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)(int)r;
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// inclusive prefix sum of v over the block, in thread order; *total gets
// the block's sum.  Every thread must call it.
__device__ __forceinline__ unsigned block_inclusive_scan(unsigned v,
                                                         unsigned* warp_tot,
                                                         unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_inclusive_scan(v);
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const unsigned w =
        warp_inclusive_scan(lane < kWarps ? warp_tot[lane] : 0u);
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const unsigned base = warp > 0 ? warp_tot[warp - 1] : 0u;
  *total = warp_tot[kWarps - 1];
  __syncthreads();   // warp_tot may be reused by the caller
  return v + base;
}

// Warp 0: which of n (<= 32 E) counts fetch(i) holds rank rnk of their
// concatenation -> (index, count below it, its count).  Lane l takes
// entries E l .. E l + E - 1; exactly one lane writes.
template <int E, typename Fetch>
__device__ __forceinline__ void warp_find(Fetch fetch, int n, unsigned rnk,
                                          unsigned* idx, unsigned* below,
                                          unsigned* count) {
  const int lane = threadIdx.x & 31;
  unsigned a[E], sum = 0;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    a[i] = E * lane + i < n ? fetch(E * lane + i) : 0u;
    sum += a[i];
  }
  unsigned run = warp_inclusive_scan(sum) - sum;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (run <= rnk && rnk < run + a[i]) {
      *idx = E * lane + i;
      *below = run;
      *count = a[i];
    }
    run += a[i];
  }
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
fed_compress_cluster_kernel(const float* __restrict__ ef,
                            int8_t* __restrict__ q_out,
                            float* __restrict__ scale_out, int P, int k,
                            int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  Ctl& ctl = *reinterpret_cast<Ctl*>(smem);
  unsigned* hists = reinterpret_cast<unsigned*>(smem + sizeof(Ctl));
  float* data = reinterpret_cast<float*>(hists + 2 * kBins);
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / CS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const long long lo = min((long long)rank * S, (long long)P);
  const int n = (int)(min(lo + S, (long long)P) - lo);
  const float* e = ef + (long long)row * P + lo;
  int8_t* q = q_out + (long long)row * P + lo;
  // group t holds slice coordinates 4t - pad .. 4t - pad + 3, where q's
  // address is a multiple of 4; the 16-byte path needs e's float phase to
  // match
  const int pad = (int)((uintptr_t)q & 3);
  const bool vec = ((uintptr_t)e & 15) == (uintptr_t)(4 * pad);
  const int G = (pad + n + 3) >> 2;

  auto sync_cluster = [&]() {
    if (CS > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
  };
  auto remote = [&](unsigned* p, int r) -> const unsigned* {
    return CS > 1 ? cluster.map_shared_rank(p, r) : p;
  };
  auto valid = [&](int j) { return (unsigned)j < (unsigned)n; };
  auto group = [&](int t) -> float4 {
    if (kResident) return *reinterpret_cast<const float4*>(data + 4 * t);
    const int j0 = 4 * t - pad;
    if (vec && j0 >= 0 && j0 + 4 <= n)
      return __ldg(reinterpret_cast<const float4*>(e + j0));
    float4 r;
    r.x = valid(j0) ? e[j0] : 0.0f;
    r.y = valid(j0 + 1) ? e[j0 + 1] : 0.0f;
    r.z = valid(j0 + 2) ? e[j0 + 2] : 0.0f;
    r.w = valid(j0 + 3) ? e[j0 + 3] : 0.0f;
    return r;
  };
  // f(x) for every coordinate of the slice, in no particular order
  auto sweep = [&](auto&& f) {
    constexpr int U = kResident ? 1 : kStreamGroups;
    for (int t0 = tid; t0 < G; t0 += U * kThreads) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t0 + u * kThreads < G) v[u] = group(t0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * kThreads;
        if (t < G) {
          const int j0 = 4 * t - pad;
          if (valid(j0)) f(v[u].x);
          if (valid(j0 + 1)) f(v[u].y);
          if (valid(j0 + 2)) f(v[u].z);
          if (valid(j0 + 3)) f(v[u].w);
        }
      }
    }
  };
  auto store = [&](int t, char4 c) {
    const int j0 = 4 * t - pad;
    if (j0 >= 0 && j0 + 4 <= n) {
      *reinterpret_cast<char4*>(q + j0) = c;
    } else {
      if (valid(j0)) q[j0] = c.x;
      if (valid(j0 + 1)) q[j0 + 1] = c.y;
      if (valid(j0 + 2)) q[j0 + 2] = c.z;
      if (valid(j0 + 3)) q[j0 + 3] = c.w;
    }
  };

  // 1. the slice into shared memory (resident route)
  if (kResident) {
    for (int t = tid; t < G; t += kThreads) {
      const int j0 = 4 * t - pad;
      if (vec && j0 >= 0 && j0 + 4 <= n) {
        cp_async16(data + 4 * t, e + j0);
      } else {
        for (int i = 0; i < 4; ++i)
          if (valid(j0 + i)) cp_async4(data + 4 * t + i, e + j0 + i);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const bool select = k > 0 && k < P;
  if (select)
    for (int b = tid; b < kBins; b += kThreads) hists[b] = 0;
  if (kResident) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. radix select of rank P - k (ascending) over the bits of |e|; pass 0
  // also takes amax
  unsigned prefix = 0, known = 0;         // fixed high bits and their mask
  unsigned rnk = (unsigned)(P - k);
  unsigned below = 0, n_eq = 0, bin = 0;  // coordinates < thr, == thr
  float scale = 0.0f;
  for (int p = 0; p < (select ? kPasses : 1); ++p) {
    const int par = p & 1, shift = pass_shift(p), nb = pass_bins(p);
    unsigned* hist = hists + par * kBins;
    if (p > 0) {
      for (int b = tid; b < nb; b += kThreads) hist[b] = 0;
      __syncthreads();
      sweep([&](float x) {
        const unsigned u = abs_bits(x);
        if ((u & known) == prefix)
          atomicAdd(&hist[(u >> shift) & (unsigned)(nb - 1)], 1u);
      });
    } else {
      unsigned m = 0;
      if (select) {
        sweep([&](float x) {
          const unsigned u = abs_bits(x);
          m = max(m, u);
          atomicAdd(&hist[u >> pass_shift(0)], 1u);
        });
      } else {
        sweep([&](float x) { m = max(m, abs_bits(x)); });
      }
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) ctl.warp_tot[warp] = m;
    }
    __syncthreads();
    if (p == 0 && warp == 0)
      ctl.amax = __reduce_max_sync(
          0xffffffffu, lane < kWarps ? ctl.warp_tot[lane] : 0u);
    // the chunk sums of this CTA's histogram: 8 bins a thread, 8 threads
    // a chunk
    const int nc = nb / kChunk;
    if (select) {
      unsigned s8 = 0;
      if (8 * tid < nb) {
        const uint4 a = reinterpret_cast<const uint4*>(hist)[2 * tid];
        const uint4 b = reinterpret_cast<const uint4*>(hist)[2 * tid + 1];
        s8 = a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
      }
      s8 += __shfl_xor_sync(0xffffffffu, s8, 1);
      s8 += __shfl_xor_sync(0xffffffffu, s8, 2);
      s8 += __shfl_xor_sync(0xffffffffu, s8, 4);
      if ((tid & 7) == 0 && 8 * tid < nb) ctl.csum[par][tid >> 3] = s8;
    }
    sync_cluster();   // the pass's one barrier: every histogram complete
    if (p == 0) {
      if (tid < CS) ctl.ranks[tid] = *remote(&ctl.amax, tid);
      __syncthreads();
      unsigned amax = 0;
      for (int r = 0; r < CS; ++r) amax = max(amax, ctl.ranks[r]);
      scale = __fmul_rn(__uint_as_float(amax), 1.0f / 127.0f);
      if (rank == 0 && tid == 0) scale_out[row] = scale;
      if (!select || !(scale > 0.0f)) break;   // the same in every CTA
    }
    // the chunk holding rank rnk, from the ranks' chunk sums, then its bin
    // from the chunk's bins of every rank (warp 0 reads them remotely, the
    // ranks in rank order)
    auto over_ranks = [&](unsigned* p, int i) {
      unsigned sum = 0;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < CS) sum += remote(p, r)[i];
      return sum;
    };
    if (warp == 0)
      warp_find<2>([&](int i) { return over_ranks(&ctl.csum[par][0], i); },
                   nc, rnk, &ctl.sel_c, &ctl.sel_base, &ctl.sel_eq);
    __syncthreads();
    const unsigned c = ctl.sel_c, base = ctl.sel_base;
    if (warp == 0)
      warp_find<2>(
          [&](int i) { return over_ranks(hist, (int)c * kChunk + i); },
          kChunk, rnk - base, &ctl.sel_bin, &ctl.sel_below, &ctl.sel_eq);
    __syncthreads();
    bin = c * kChunk + ctl.sel_bin;
    const unsigned sel_below = base + ctl.sel_below;
    rnk -= sel_below;
    below += sel_below;
    n_eq = ctl.sel_eq;
    prefix |= bin << shift;
    known |= (unsigned)(nb - 1) << shift;
  }

  if (!select || !(scale > 0.0f)) {   // the same branch in every CTA
    if (CS > 1) cluster_arrive();     // done with the ranks' amax
    const bool all = k >= P && scale > 0.0f;
    for (int t = tid; t < G; t += kThreads) {
      char4 c = make_char4(0, 0, 0, 0);
      if (all) {
        const float4 v = group(t);
        c = make_char4(quantise(v.x, scale), quantise(v.y, scale),
                       quantise(v.z, scale), quantise(v.w, scale));
      }
      store(t, c);
    }
    if (CS > 1) cluster_wait();
    return;
  }

  // 3. this CTA's ties at thr (its last histogram's bin) and the lower
  // ranks'
  const unsigned* last = hists + ((kPasses - 1) & 1) * kBins;
  const unsigned mine = last[bin];
  if (warp == 0) {
    unsigned v = lane < rank
        ? remote(hists + ((kPasses - 1) & 1) * kBins, lane)[bin] : 0u;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0) ctl.tie_base = v;
  }
  __syncthreads();
  const unsigned tie_base = ctl.tie_base;
  if (CS > 1) cluster_arrive();        // no more remote reads

  // 4. the earliest ties: need = k - count(|e| > thr) >= 1 of them, the
  // lower ranks' first; only the CTA that holds the cut-off counts its own
  // in index order (a block scan per 2,048 coordinates)
  const unsigned thr = prefix;
  const int need = k - (P - (int)below - (int)n_eq);
  const long long left = (long long)need - (long long)tie_base;
  const unsigned take = (unsigned)max(0LL, min(left, (long long)mine));
  const bool ordered = take != 0 && take != mine;

  // 5. mask + quantise, four coordinates a thread
  unsigned run_base = 0;
  for (int t0 = 0; t0 < G; t0 += kThreads) {
    const int t = t0 + tid, j0 = 4 * t - pad;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t < G) v = group(t);
    const float x[4] = {v.x, v.y, v.z, v.w};
    unsigned gt = 0, eq = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = abs_bits(x[i]);
      const bool ok = t < G && valid(j0 + i);
      gt |= (unsigned)(ok && u > thr) << i;
      eq |= (unsigned)(ok && u == thr) << i;
    }
    unsigned keep = gt | (take ? eq : 0u);
    if (ordered) {
      const unsigned cnt = __popc(eq);
      unsigned total;
      unsigned seen = run_base +
                      block_inclusive_scan(cnt, ctl.warp_tot, &total) - cnt;
      run_base += total;
      keep = gt;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if ((eq >> i) & 1u) keep |= (unsigned)(seen++ < take) << i;
    }
    if (t < G) {
      int8_t c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        c[i] = (keep >> i) & 1u ? quantise(x[i], scale) : (int8_t)0;
      store(t, make_char4(c[0], c[1], c[2], c[3]));
    }
  }
  if (CS > 1) cluster_wait();          // no CTA leaves while read remotely
}

// A launch of K clusters of CS CTAs along x.
static cudaLaunchConfig_t cluster_config(int K, int CS, long long smem,
                                         void* stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * CS);
  cfg.blockDim = dim3(kThreads);
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

static void* pick_kernel(int resident) {
  return resident ? (void*)fed_compress_cluster_kernel<true>
                  : (void*)fed_compress_cluster_kernel<false>;
}

extern "C" long long fed_compress_topk_q8_smem_bytes(int S, int resident) {
  return smem_layout_bytes(S, resident != 0);
}

// How many clusters of CS CTAs with smem bytes each can be resident at
// once; a negative value is a CUDA error code.
extern "C" int fed_compress_topk_q8_max_clusters(int CS, int resident,
                                                 long long smem) {
  const void* fn = pick_kernel(resident);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, CS, smem, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

extern "C" int fed_compress_topk_q8_launch(const void* ef, void* q_out,
                                           void* scale_out, int K, int P,
                                           int k, int CS, int S,
                                           int resident, long long smem,
                                           void* stream) {
  if (K <= 0 || P <= 0) return 0;
  if (CS < 1 || CS > kMaxCluster || (CS & (CS - 1)) || S < 4 || S % 4 ||
      (long long)S * CS < P || smem != smem_layout_bytes(S, resident))
    return (int)cudaErrorInvalidValue;
  const void* fn = pick_kernel(resident);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(K, CS, smem, stream, attr);
  const float* efp = (const float*)ef;
  int8_t* qp = (int8_t*)q_out;
  float* sp = (float*)scale_out;
  e = resident ? cudaLaunchKernelEx(&cfg, fed_compress_cluster_kernel<true>,
                                    efp, qp, sp, P, k, S)
               : cudaLaunchKernelEx(&cfg, fed_compress_cluster_kernel<false>,
                                    efp, qp, sp, P, k, S);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* fed_compress_topk_q8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
