// Backward of the Mamba-1 selective scan, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's backward of its scan op
// (src/repro/kernels/ops.py _ss_bwd) is jax.vjp of its plain lax.scan
// oracle, the reverse of one scan, linear in S; this kernel is the port's
// counterpart of _ss_bwd.  For every batch row b and channel c, with the
// forward h_t = a_t * h_{t-1} + (dt_t x_t) B_t, a_t = exp(dt_t A), and the
// cotangents gy [B, S, d] of y and ghT [B, d, N] of hT:
//
//   lam_t = gy_t C_t + a_{t+1} * lam_{t+1}     (from lam = ghT past S - 1)
//   dC_t[n] = sum_c gy_t h_t          dB_t[n] = sum_c lam_t dt_t x_t
//   dx_t = dt_t sum_n lam_t B_t       ddt_t = x_t sum_n lam_t B_t
//                                             + sum_n lam_t h_{t-1} a_t A
//   dA = sum_{b,t} lam_t h_{t-1} a_t dt_t,     dh0 = a_0 * lam_0
//
// all float32.  Neither the [B, S, d, N] states nor lam exist in device
// memory: the training forward (selective_scan.cu's checkpointing
// instance) leaves h at the start of every chunk of CH = ckpt_steps(NP)
// (scan_ckpt.cuh) steps in a [B, ceil(S / CH), d, N] buffer, and each chunk is recomputed
// from it here.
//
// What bounds it on this card: bytes and instruction issue together, and
// latency where too few warps run.  Per (b, t, c) it must read dt, x and
// gy and write ddt and dx (20 bytes), per state and step take one exp and
// ~19 float32 operations; at Falcon-Mamba-7B's width (d = 8192, N = 16),
// B = 1, S = 4096 that is ~0.67 GB (0.20 ms at 3.35 TB/s), 5.4e8 exps
// (0.13 ms) and 1.0e10 flop (0.15 ms).  What it moves besides: the
// checkpoints (134 MB), B and C once per block (from L2), the per-block
// dB/dC partials (67 MB each way).  dB and dC are sums over all d
// channels, which span blocks, and ddt and dx sums over the N states of a
// channel: both take shuffles and shared-memory traffic beside the flop.
// The serial chains over t (h forward, lam backward) need many warps.
//
// What the design does about it:
// - the training forward leaves the checkpoints, so the backward runs no
//   forward pass (its first version ran one, and 3 exps a state and
//   step);
// - one block per (64 channels, b), 512 threads: each channel's N states
//   split over LANES = 8 adjacent lanes, NP / 8 states a lane (NP = N
//   padded to 8..64); at B = 1 that is 128 blocks of 16 warps, one on
//   each of 128 SMs (<= 128 registers a thread); 64 channels a block
//   rather than 32 halve the per-block dB/dC partials and the B and C
//   rows the blocks stage;
// - the chunks in reverse, staged by cp.async into a ring of STAGES
//   chunks in dynamic shared memory, issued STAGES - 1 chunks ahead: the
//   chunk's dt, x, gy (16-byte copies when d % 4 == 0 and the bases are
//   aligned), B, C and the block's checkpoint rows;
// - a chunk's h_t and a_t are recomputed from the checkpoint into
//   registers (CH x NP / 8 each: 32 + 32 at N = 16), so each state and
//   step takes one ex2.approx, and the recompute is the forward kernel's
//   arithmetic, bit for bit; then lam walks back through the chunk; the
//   steps are not guarded (past S they were staged as zeros, which leave
//   h, lam and dA unchanged), so each loop is one block of code;
// - ddt and dx: each lane's partials over its states go to shared memory
//   and are summed over the channel's 8 lanes in a fixed tree when the
//   chunk's rows are written, coalesced;
// - dB and dC: summed over the warp's 4 channels by a reduce-scatter of
//   shuffles, over the block's 16 warps in shared memory in warp order, and
//   over the blocks by a second kernel in block order, from per-block
//   partials [2, blocks, B, S, N].  Summing them first over the blocks of
//   a thread-block cluster in distributed shared memory would cut the
//   partials by the cluster size, but measured slower on the card
//   (PERF.md section 7): each chunk's cluster barrier must release the
//   block sums, a GPU-wide memory barrier in every thread, and clusters of
//   4 or 8 cannot all be resident at B = 1;
// - dA's per-(b, channel) sums over t stay in registers and the second
//   kernel sums them over b in order.  Every sum has a fixed order and
//   there are no atomics, so a run is bitwise repeatable.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_ckpt.cuh"

namespace {

constexpr int LANES = 8;                      // lanes per channel
constexpr int CHANNELS = 64;                  // channels per block
constexpr int THREADS = CHANNELS * LANES;     // 512
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;                     // chunks in the ring
constexpr float LOG2E = 1.4426950408889634f;

template <int NP>
struct __align__(16) Stage {
  static constexpr int CH = ckpt_steps(NP);
  float dt[CH][CHANNELS];
  float x[CH][CHANNELS];
  float gy[CH][CHANNELS];
  float B[CH][NP];
  float C[CH][NP];
  float hc[CHANNELS][NP];                     // h before the chunk
};

template <int NP>
struct __align__(16) Smem {
  static constexpr int CH = ckpt_steps(NP);
  static constexpr int E = CH * 2 * NP;       // a chunk's dB | dC rows
  Stage<NP> ring[STAGES];
  float pl[2][CH][CHANNELS][LANES];           // ddt, dx per-lane partials
  float red[WARPS][E];                        // per-warp dB | dC sums
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void copy4(float* smem, const float* gmem,
                                      bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(on ? 4 : 0));
}

__device__ __forceinline__ void copy16(float* smem, const float* gmem,
                                       bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(on ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING));
}

// Stage chunk k (steps t0 .. t0 + CH - 1) of the block's channels
// [c0, c0 + 64): rows past S, channels past d and states past N read 0.
// ``ck`` is the chunk's checkpoint, [d, N].
template <int NP, bool VEC>
__device__ __forceinline__ void stage(Stage<NP>& st, const float* dtb,
                                      const float* xb, const float* gyb,
                                      const float* Bb, const float* Cb,
                                      const float* ck, int t0, int S, int c0,
                                      int d, int N) {
  constexpr int CH = Stage<NP>::CH;
  const int tid = threadIdx.x;
  if (VEC) {
    for (int i = tid; i < CH * CHANNELS / 4; i += THREADS) {
      const int r = i / (CHANNELS / 4), v = (i % (CHANNELS / 4)) * 4;
      const bool on = t0 + r < S && c0 + v < d;
      const long long o = on ? (long long)(t0 + r) * d + c0 + v : 0;
      copy16(&st.dt[r][v], dtb + o, on);
      copy16(&st.x[r][v], xb + o, on);
      copy16(&st.gy[r][v], gyb + o, on);
    }
  } else {
    for (int i = tid; i < CH * CHANNELS; i += THREADS) {
      const int r = i / CHANNELS, v = i % CHANNELS;
      const bool on = t0 + r < S && c0 + v < d;
      const long long o = on ? (long long)(t0 + r) * d + c0 + v : 0;
      copy4(&st.dt[r][v], dtb + o, on);
      copy4(&st.x[r][v], xb + o, on);
      copy4(&st.gy[r][v], gyb + o, on);
    }
  }
  for (int i = tid; i < CH * NP; i += THREADS) {
    const int r = i / NP, n = i % NP;
    const bool on = t0 + r < S && n < N;
    const long long o = on ? (long long)(t0 + r) * N + n : 0;
    copy4(&st.B[r][n], Bb + o, on);
    copy4(&st.C[r][n], Cb + o, on);
  }
  for (int i = tid; i < CHANNELS * NP; i += THREADS) {
    const int c = i / NP, n = i % NP;
    const bool on = c0 + c < d && n < N;
    copy4(&st.hc[c][n], ck + (on ? (long long)(c0 + c) * N + n : 0), on);
  }
}

// Reduce-scatter of the V values ``v`` over the lanes ``m``, ``m / 2``, ..,
// ``lo`` apart (each a power of two): each round halves what a thread keeps
// while it holds more than one value, then sums plainly.  Returns the
// index of this thread's first value; ``cnt`` its count (kept first in v).
template <int V>
__device__ __forceinline__ int reduce_scatter(float (&v)[V], int wl, int m,
                                              int lo, int& cnt) {
  int off = 0;
  cnt = V;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    if (m < lo) break;
    const bool up = wl & m;
    if (cnt >= 2) {
      const int half = cnt / 2;
#pragma unroll
      for (int q = 0; q < V / 2; ++q) {
        if (q < half) {
          const float keep = up ? v[half + q] : v[q];
          const float send = up ? v[q] : v[half + q];
          v[q] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
      }
      off += up ? half : 0;
      cnt = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
    }
    m >>= 1;
  }
  return off;
}

template <int NP, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
selective_scan_bwd_kernel(const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ x,
                          const float* __restrict__ gy,
                          const float* __restrict__ ghT,
                          const float* __restrict__ ckpt,
                          float* __restrict__ ddt, float* __restrict__ dx,
                          float* __restrict__ dh0,
                          float* __restrict__ part,
                          float* __restrict__ dA_part, int Bsz, int S,
                          int d, int N) {
  constexpr int NPL = NP / LANES;             // states per lane
  constexpr int CH = Smem<NP>::CH;
  constexpr int E = Smem<NP>::E;
  constexpr int V = 2 * NPL;                  // dB and dC values a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NP>& sm = *reinterpret_cast<Smem<NP>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % LANES;               // which eighth of the states
  const int cl = tid / LANES;                 // channel in the block
  const int wl = tid % 32, warp = tid / 32;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CHANNELS;
  const int ch = c0 + cl;
  const bool live = ch < d;
  const int chunks = (S + CH - 1) / CH;

  float a2[NPL], Av[NPL], mu[NPL], dA_acc[NPL];
  const long long state = ((long long)b * d + ch) * N;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int n = lane * NPL + i;
    const bool on = live && n < N;
    Av[i] = on ? A[(long long)ch * N + n] : 0.f;
    a2[i] = Av[i] * LOG2E;
    mu[i] = on ? ghT[state + n] : 0.f;        // a_{t+1} lam_{t+1}
    dA_acc[i] = 0.f;
  }

  const long long seq = (long long)b * S;
  const float* dtb = dt + seq * d;
  const float* xb = x + seq * d;
  const float* gyb = gy + seq * d;
  const float* Bb = Bm + seq * N;
  const float* Cb = Cm + seq * N;
  const float* ckb = ckpt + (long long)b * chunks * d * N;
  auto stage_chunk = [&](int slot, int k) {
    stage<NP, VEC>(sm.ring[slot], dtb, xb, gyb, Bb, Cb,
                   ckb + (long long)k * d * N, k * CH, S, c0, d, N);
  };

  // entry e of chunk k's dB | dC rows into the partials [2, blocks, B,
  // S, N] (rows past S and states past N dropped)
  auto put = [&](int k, int e, float s) {
    const int j = e / (2 * NP), kind = e % (2 * NP) / NP, n = e % NP;
    if (k * CH + j < S && n < N)
      part[(((long long)kind * gridDim.x + blockIdx.x) * Bsz + b) * S * N
           + (long long)(k * CH + j) * N + n] = s;
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (chunks - 1 - s >= 0) stage_chunk(s, chunks - 1 - s);
    commit();
  }
  for (int it = 0; it < chunks; ++it) {
    const int k = chunks - 1 - it;            // the chunks in reverse
    wait_pending<STAGES - 2>();               // chunk k has landed ...
    __syncthreads();                          // ... for every thread, and
                                              // the last one is consumed
    if (k - (STAGES - 1) >= 0)
      stage_chunk((it + STAGES - 1) % STAGES, k - (STAGES - 1));
    commit();
    const Stage<NP>& st = sm.ring[it % STAGES];
    const int t0 = k * CH;
    const int len = min(CH, S - t0);

    // recompute the chunk's h_t and a_t from its checkpoint.  Steps past
    // S (the last chunk's) were staged as zeros: a_t = 1 and h, lam and dA
    // pass them unchanged, so no step is guarded and each loop below is one
    // straight block of code that the compiler can schedule across steps
    float hp[NPL];                            // h before the chunk
#pragma unroll
    for (int i = 0; i < NPL; ++i) hp[i] = st.hc[cl][lane * NPL + i];
    float hs[CH][NPL], as[CH][NPL];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float dtv = st.dt[j][cl];
      const float dbx = dtv * st.x[j][cl];
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const float prev = j == 0 ? hp[i] : hs[j - 1][i];
        as[j][i] = ex2(dtv * a2[i]);
        hs[j][i] = fmaf(as[j][i], prev, dbx * st.B[j][lane * NPL + i]);
      }
    }

    // lam back through the chunk
#pragma unroll
    for (int j = CH - 1; j >= 0; --j) {
      const float dtv = st.dt[j][cl], xv = st.x[j][cl];
      const float gv = st.gy[j][cl];
      const float dbx = dtv * xv;
      float v[V];                             // dB | dC partials
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int n = lane * NPL + i;
        const float prev = j == 0 ? hp[i] : hs[j - 1][i];
        const float lam = fmaf(gv, st.C[j][n], mu[i]);
        v[i] = lam * dbx;
        v[NPL + i] = gv * hs[j][i];
        s1 = fmaf(lam, st.B[j][n], s1);
        mu[i] = as[j][i] * lam;
        const float r = mu[i] * prev;         // lam_t a_t h_{t-1}
        s2 = fmaf(r, Av[i], s2);
        dA_acc[i] = fmaf(r, dtv, dA_acc[i]);
      }
      // ddt and dx: this lane's partials, summed over the lanes later
      sm.pl[0][j][cl][lane] = fmaf(xv, s1, s2);
      sm.pl[1][j][cl][lane] = dtv * s1;
      // dB and dC over the warp's 4 channels (lanes 16 and 8 apart)
      int cnt;
      const int off = reduce_scatter<V>(v, wl, 16, LANES, cnt);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (q < cnt) {
          const int gq = off + q;
          const int kind = gq / NPL, n = lane * NPL + gq % NPL;
          sm.red[warp][j * 2 * NP + kind * NP + n] = v[q];
        }
      }
    }
    __syncthreads();
    // the chunk's ddt and dx rows, each the sum of its 8 lanes' partials
    // ((l0 + l1) + (l2 + l3)) + ((l4 + l5) + (l6 + l7)), coalesced
    for (int i = tid; i < 2 * CH * CHANNELS; i += THREADS) {
      const int kind = i / (CH * CHANNELS);
      const int r = i / CHANNELS % CH, c = i % CHANNELS;
      if (r < len && c0 + c < d) {
        const float4 u = ld4(&sm.pl[kind][r][c][0]);
        const float4 w = ld4(&sm.pl[kind][r][c][4]);
        (kind ? dx : ddt)[(seq + t0 + r) * d + c0 + c] =
            ((u.x + u.y) + (u.z + u.w)) + ((w.x + w.y) + (w.z + w.w));
      }
    }
    // dB and dC over the block's warps, in warp order: the block's
    // partials
    for (int e = tid; e < E; e += THREADS) {
      float s = sm.red[0][e];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += sm.red[w][e];
      put(k, e, s);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int n = lane * NPL + i;
      if (n < N) {
        dh0[state + n] = mu[i];
        dA_part[state + n] = dA_acc[i];
      }
    }
  }
}

// dB and dC: the blocks' partials summed in block order; dA: the per-row
// partials summed in row order.
__global__ void __launch_bounds__(256)
selective_scan_bwd_reduce_kernel(const float* __restrict__ part,
                                 const float* __restrict__ dA_part,
                                 float* __restrict__ dB,
                                 float* __restrict__ dC,
                                 float* __restrict__ dA, int blocks,
                                 int Bsz, long long E, long long dN) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 2 * E) {
    const int kind = (int)(i / E);
    const long long e = i % E;
    const float* p = part + (long long)kind * blocks * E + e;
    float s = 0.f;
    for (int k = 0; k < blocks; ++k) s += p[(long long)k * E];
    (kind ? dC : dB)[e] = s;
  } else if (i < 2 * E + dN) {
    const long long e = i - 2 * E;
    float s = 0.f;
    for (int b = 0; b < Bsz; ++b) s += dA_part[(long long)b * dN + e];
    dA[e] = s;
  }
}

int grid_blocks(int d) { return (d + CHANNELS - 1) / CHANNELS; }

template <int NP, bool VEC>
int launch(const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* x, const void* gy, const void* ghT, const void* ckpt,
           void* ddt, void* dA, void* dB, void* dC, void* dx, void* dh0,
           void* part, void* dA_part, int B, int S, int d, int N,
           cudaStream_t stream) {
  auto fn = selective_scan_bwd_kernel<NP, VEC>;
  const int smem = (int)sizeof(Smem<NP>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  selective_scan_bwd_kernel<NP, VEC>
      <<<dim3(grid_blocks(d), B), THREADS, smem, stream>>>(
      (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)x, (const float*)gy, (const float*)ghT,
      (const float*)ckpt, (float*)ddt, (float*)dx, (float*)dh0,
      (float*)part, (float*)dA_part, B, S, d, N);
  int code = (int)cudaGetLastError();
  if (code) return code;
  const long long E = (long long)B * S * N, dN = (long long)d * N;
  const long long total = 2 * E + dN;
  selective_scan_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256,
                                     0, stream>>>(
      (const float*)part, (const float*)dA_part, (float*)dB, (float*)dC,
      (float*)dA, grid_blocks(d), B, E, dN);
  return (int)cudaGetLastError();
}

int padded(int N) {
  int NP = 8;
  while (NP < N) NP *= 2;
  return NP;
}

}  // namespace

// Blocks along d (the dB/dC partials' second axis, [2, blocks, B, S, N]).
extern "C" int selective_scan_bwd_blocks(int d) {
  return d < 1 ? 0 : grid_blocks(d);
}

extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* x, const void* gy, const void* ghT, const void* ckpt,
    void* ddt, void* dA, void* dB, void* dC, void* dx, void* dh0,
    void* part, void* dA_part, int B, int S, int d, int N, void* stream) {
  if (B <= 0 || d <= 0) return 0;
  if (N <= 0 || N > 64 || S < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(dt) |
                     reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(gy)) % 16 == 0);
#define SSB_LAUNCH(NP, VEC)                                                 \
  launch<NP, VEC>(dt, A, Bm, Cm, x, gy, ghT, ckpt, ddt, dA, dB, dC, dx,    \
                  dh0, part, dA_part, B, S, d, N, st)
#define SSB_PICK(NP) return vec ? SSB_LAUNCH(NP, true) : SSB_LAUNCH(NP, false)
  switch (padded(N)) {
    case 8: SSB_PICK(8);
    case 16: SSB_PICK(16);
    case 32: SSB_PICK(32);
    default: SSB_PICK(64);
  }
#undef SSB_PICK
#undef SSB_LAUNCH
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
