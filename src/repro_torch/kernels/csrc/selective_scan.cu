// Mamba-1 selective scan (the SSM recurrence), hand-written for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py selective_scan_fwd
// (_scan_kernel, pallas_call at :63).  For every batch row b and channel c
// of d, with state h[N] starting at h0[b, c, :]:
//
//   dA   = exp(dt[b,t,c] * A[c,:])
//   h    = dA * h + (dt[b,t,c] * x[b,t,c]) * B[b,t,:]
//   y[b,t,c] = sum_n h[n] * C[b,t,n]
//
// over t = 0 .. S-1 in order, and hT[b, c, :] = h at the end; all float32.
// The [B, S, d, N] state tensor never exists in device memory.
//
// What bounds it on this card: three things at once.  Per (b, t, c) it
// reads dt and x and writes y (12 bytes), and per state it takes one exp
// on the special-function units (16 a clock per SM), ~4 float32 operations
// and two shared-memory words (B_t[n] and C_t[n], 32 a clock per SM).  At
// Falcon-Mamba-7B's width (d = 8192, N = 16) the exps (~0.128 ms at B = 4,
// S = 1024) and the bytes (~0.122 ms) are nearly equal, and the serial
// chain over t must be hidden by parallel work, not waited on.
//
// What the design does about it:
// - each channel's N states are split over LANES = 4 adjacent lanes (NP/4
//   states each, NP = N padded to 4..64), so the B * d channels give four
//   times as many threads; y_t is summed across the four lanes with a
//   fixed shuffle tree, four steps at a time as a reduce-scatter (3
//   shuffles for 4 steps, each lane ends with one step's y), so
//   y = (q0 + q2) + (q1 + q3) for the lanes' partial sums q, in the same
//   order on every run (ref.selective_scan_lanes models it);
// - each thread runs CPT = 2 adjacent channels on the same states, so
//   every B_t[n] and C_t[n] it reads from shared memory serves two
//   channels (the reads would otherwise match the exps one for one);
// - log2(e) is folded into A once, so each exp is one ex2.approx;
// - the sequence is staged in chunks of CH = 16 steps (dt, x of the block's
//   64 channels, and B_t, C_t) by cp.async into a ring of STAGES chunks
//   in shared memory, issued STAGES - 1 chunks ahead, so the next chunks'
//   loads are in flight while this one is computed (one barrier a chunk);
//   dt and x go in 16-byte copies when d % 4 == 0 and the bases are
//   16-byte aligned, in 4-byte copies otherwise; rows past S, channels
//   past d and states past N are zero-filled; decode's S = 1 skips the
//   ring and reads its one step straight from global memory;
// - 128-thread blocks of 64 channels: Falcon's B * d / 64 = 512 blocks sit
//   on the 132 SMs in one wave, ~16 warps each;
// - training's instance (CKPT) also stores h at the start of every chunk
//   of CK = ckpt_steps(NP) steps (scan_ckpt.cuh: 16 up to N = 16, 8 up to 32, 4 up to 64)
//   into a [B, ceil(S / CK), d, N] buffer, from the same registers the
//   recurrence runs in: the backward (selective_scan_bwd.cu) recomputes
//   each chunk from it with the same ex2.approx and FMA order, so its h_t
//   are this kernel's bit for bit, and it never re-runs the forward.  At
//   Falcon's width, B = 1, S = 4,096, that is 134 MB of stores beside the
//   forward's 0.27 GB of traffic.  Serving's instance (prefill, decode)
//   has no such stores: the C entry takes a null buffer there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_ckpt.cuh"

namespace {

constexpr int LANES = 4;                      // lanes per channel
constexpr int CPT = 2;                        // channels per thread
constexpr int CHANNELS = 64;                  // channels per block
constexpr int THREADS = CHANNELS / CPT * LANES;
constexpr int CH = 16;                        // steps per staged chunk
constexpr int GROUP = 4;                      // steps per y reduce-scatter
constexpr float LOG2E = 1.4426950408889634f;
static_assert(GROUP == LANES, "each lane keeps one step of a group");
static_assert(CH % GROUP == 0, "a chunk holds whole groups");

template <int NP>
struct __align__(16) Stage {
  float dt[CH][CHANNELS];
  float x[CH][CHANNELS];
  float B[CH][NP];
  float C[CH][NP];
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
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

// Stage chunk ``t0 .. t0 + CH - 1`` of the block's channels [c0, c0 + 64)
// into ``st``; every thread issues its share, nothing waits.
template <int NP, bool VEC>
__device__ __forceinline__ void stage_chunk(Stage<NP>& st,
                                            const float* dtb,
                                            const float* xb,
                                            const float* Bb,
                                            const float* Cb, int t0, int S,
                                            int c0, int d, int N) {
  const int tid = threadIdx.x;
  if (VEC) {
    for (int i = tid; i < CH * CHANNELS / 4; i += THREADS) {
      const int r = i / (CHANNELS / 4), v = (i % (CHANNELS / 4)) * 4;
      const bool on = t0 + r < S && c0 + v < d;
      const long long o = on ? (long long)(t0 + r) * d + c0 + v : 0;
      copy16(&st.dt[r][v], dtb + o, on);
      copy16(&st.x[r][v], xb + o, on);
    }
  } else {
    for (int i = tid; i < CH * CHANNELS; i += THREADS) {
      const int r = i / CHANNELS, v = i % CHANNELS;
      const bool on = t0 + r < S && c0 + v < d;
      const long long o = on ? (long long)(t0 + r) * d + c0 + v : 0;
      copy4(&st.dt[r][v], dtb + o, on);
      copy4(&st.x[r][v], xb + o, on);
    }
  }
  for (int i = tid; i < CH * NP; i += THREADS) {
    const int r = i / NP, n = i % NP;
    const bool on = t0 + r < S && n < N;
    const long long o = on ? (long long)(t0 + r) * N + n : 0;
    copy4(&st.B[r][n], Bb + o, on);
    copy4(&st.C[r][n], Cb + o, on);
  }
}

template <int NP, bool VEC, bool CKPT>
__global__ void __launch_bounds__(THREADS, 4)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ x,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, float* __restrict__ ckpt,
                      int S, int d, int N) {
  constexpr int NPL = NP / LANES;             // states per lane
  constexpr int STAGES = NP >= 64 ? 2 : 3;    // chunks in the ring
  constexpr int CK = ckpt_steps(NP);
  static_assert(CH % CK == 0, "a chunk holds whole checkpoint intervals");
  __shared__ Stage<NP> ring[STAGES];

  const int tid = threadIdx.x;
  const int lane = tid % LANES;               // which quarter of the states
  const int cl = (tid / LANES) * CPT;         // first channel in the block
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CHANNELS;

  float a[CPT][NPL], h[CPT][NPL];
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int ch = c0 + cl + u;
    const long long state = ((long long)b * d + ch) * N;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int n = lane * NPL + i;
      const bool on = ch < d && n < N;
      a[u][i] = on ? A[(long long)ch * N + n] * LOG2E : 0.f;
      h[u][i] = on ? h0[state + n] : 0.f;
    }
  }

  const long long seq = (long long)b * S;
  const float* dtb = dt + seq * d;
  const float* xb = x + seq * d;
  float* yb = y + seq * d;
  const float* Bb = Bm + seq * N;
  const float* Cb = Cm + seq * N;
  // h before step t (t a multiple of CK) into checkpoint t / CK: a lane's
  // NPL states in 16-byte stores where N == NP (NPL % 4 == 0), else one
  // by one
  const int n_ck = (S + CK - 1) / CK;
  auto store_ckpt = [&](int t) {
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int ch = c0 + cl + u;
      float* p = ckpt + (((long long)b * n_ck + t / CK) * d + ch) * N
                 + lane * NPL;
      if constexpr (NPL % 4 == 0) {
        if (N == NP) {
          if (ch < d) {
#pragma unroll
            for (int i = 0; i < NPL; i += 4)
              *reinterpret_cast<float4*>(p + i) = make_float4(
                  h[u][i], h[u][i + 1], h[u][i + 2], h[u][i + 3]);
          }
          continue;
        }
      }
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        if (ch < d && lane * NPL + i < N) p[i] = h[u][i];
    }
  };

  if (S == 1) {                 // decode's one step: straight from global
    float bv[NPL], cv[NPL];     // memory, no staging and no barrier
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int n = lane * NPL + i;
      bv[i] = n < N ? Bb[n] : 0.f;
      cv[i] = n < N ? Cb[n] : 0.f;
    }
    if (CKPT) store_ckpt(0);
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int ch = c0 + cl + u;
      const float dtv = ch < d ? dtb[ch] : 0.f;
      const float dbx = ch < d ? dtv * xb[ch] : 0.f;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        h[u][i] = fmaf(ex2(dtv * a[u][i]), h[u][i], dbx * bv[i]);
        q = i == 0 ? h[u][i] * cv[i] : fmaf(h[u][i], cv[i], q);
      }
      // (q0 + q2) + (q1 + q3) on every lane, as in the reduce-scatter
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      if (lane == 0 && ch < d) yb[ch] = q;
    }
  }
  const int chunks = S == 1 ? 0 : (S + CH - 1) / CH;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < chunks)
      stage_chunk<NP, VEC>(ring[k], dtb, xb, Bb, Cb, k * CH, S, c0, d, N);
    commit();
  }
  for (int k = 0; k < chunks; ++k) {
    wait_pending<STAGES - 2>();               // chunk k has landed ...
    __syncthreads();                          // ... for every thread, and
                                              // chunk k - 1 is consumed
    if (k + STAGES - 1 < chunks)
      stage_chunk<NP, VEC>(ring[(k + STAGES - 1) % STAGES], dtb, xb, Bb,
                           Cb, (k + STAGES - 1) * CH, S, c0, d, N);
    commit();
    const Stage<NP>& st = ring[k % STAGES];
    const int t0 = k * CH;
    const int len = min(CH, S - t0);
#pragma unroll
    for (int g = 0; g < CH; g += GROUP) {
      if (g >= len) break;                    // uniform across the block
      float p[GROUP][CPT];                    // this lane's partial y
#pragma unroll
      for (int s = 0; s < GROUP; ++s) {
        const int t = g + s;
        if (t < len) {                        // uniform; false only at S's
          if (CKPT && t % CK == 0) store_ckpt(t0 + t);    // ragged end
          float bv[NPL], cv[NPL];
#pragma unroll
          for (int i = 0; i < NPL; ++i) {
            bv[i] = st.B[t][lane * NPL + i];
            cv[i] = st.C[t][lane * NPL + i];
          }
#pragma unroll
          for (int u = 0; u < CPT; ++u) {
            const float dtv = st.dt[t][cl + u];
            const float dbx = dtv * st.x[t][cl + u];
            float q = 0.f;
#pragma unroll
            for (int i = 0; i < NPL; ++i) {
              h[u][i] = fmaf(ex2(dtv * a[u][i]), h[u][i], dbx * bv[i]);
              q = i == 0 ? h[u][i] * cv[i] : fmaf(h[u][i], cv[i], q);
            }
            p[s][u] = q;
          }
        } else {
#pragma unroll
          for (int u = 0; u < CPT; ++u) p[s][u] = 0.f;
        }
      }
      // reduce-scatter over the channel's 4 lanes: after the xor-2 round a
      // lane holds steps {0,1} (lane bit 1 clear) or {2,3} summed over
      // itself and lane ^ 2; after the xor-1 round, step ``lane`` summed
      // over all four
      const bool up2 = lane & 2, up1 = lane & 1;
      float yv[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        float k0 = up2 ? p[2][u] : p[0][u], k1 = up2 ? p[3][u] : p[1][u];
        const float s0 = up2 ? p[0][u] : p[2][u];
        const float s1 = up2 ? p[1][u] : p[3][u];
        k0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        k1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        const float keep = up1 ? k1 : k0, send = up1 ? k0 : k1;
        yv[u] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
      const int t = g + lane;
      if (t < len) {
        float* yt = yb + (long long)(t0 + t) * d + c0 + cl;
        if (VEC && c0 + cl + 1 < d) {
          *reinterpret_cast<float2*>(yt) = make_float2(yv[0], yv[1]);
        } else {
#pragma unroll
          for (int u = 0; u < CPT; ++u)
            if (c0 + cl + u < d) yt[u] = yv[u];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int ch = c0 + cl + u;
    const long long state = ((long long)b * d + ch) * N;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int n = lane * NPL + i;
      if (ch < d && n < N) hT[state + n] = h[u][i];
    }
  }
}

template <int NP, bool VEC, bool CKPT>
void launch_one(dim3 grid, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* x, const void* h0, void* y,
                void* hT, void* ckpt, int S, int d, int N,
                cudaStream_t stream) {
  selective_scan_kernel<NP, VEC, CKPT><<<grid, THREADS, 0, stream>>>(
      (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)x, (const float*)h0, (float*)y, (float*)hT,
      (float*)ckpt, S, d, N);
}

template <int NP>
int launch(const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* x, const void* h0, void* y, void* hT, void* ckpt,
           int B, int S, int d, int N, cudaStream_t stream) {
  const dim3 grid((d + CHANNELS - 1) / CHANNELS, B);
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(dt) |
                     reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) % 16 == 0);
  if (ckpt && vec)
    launch_one<NP, true, true>(grid, dt, A, Bm, Cm, x, h0, y, hT, ckpt, S,
                               d, N, stream);
  else if (ckpt)
    launch_one<NP, false, true>(grid, dt, A, Bm, Cm, x, h0, y, hT, ckpt, S,
                                d, N, stream);
  else if (vec)
    launch_one<NP, true, false>(grid, dt, A, Bm, Cm, x, h0, y, hT, ckpt, S,
                                d, N, stream);
  else
    launch_one<NP, false, false>(grid, dt, A, Bm, Cm, x, h0, y, hT, ckpt, S,
                                 d, N, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Steps between the checkpoints of h for state size N (the checkpoint
// buffer is [B, ceil(S / steps), d, N] float32).
extern "C" int selective_scan_ckpt_steps(int N) {
  return ckpt_steps(N);
}

// ``ckpt``: null for serving's instance, else the checkpoint buffer.
extern "C" int selective_scan_fwd_launch(const void* dt, const void* A,
                                         const void* Bm, const void* Cm,
                                         const void* x, const void* h0,
                                         void* y, void* hT, void* ckpt,
                                         int B, int S, int d, int N,
                                         void* stream) {
  if (B <= 0 || d <= 0) return 0;
  if (N <= 0 || N > 64 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SS_LAUNCH(NP) \
  launch<NP>(dt, A, Bm, Cm, x, h0, y, hT, ckpt, B, S, d, N, st)
  if (N <= 4) return SS_LAUNCH(4);
  if (N <= 8) return SS_LAUNCH(8);
  if (N <= 16) return SS_LAUNCH(16);
  if (N <= 32) return SS_LAUNCH(32);
  return SS_LAUNCH(64);
#undef SS_LAUNCH
}

extern "C" const char* selective_scan_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
