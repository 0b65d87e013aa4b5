// Backward of the Mamba-1 selective scan, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's backward of its scan op
// (src/repro/kernels/ops.py _ss_bwd) is jax.vjp of its plain lax.scan
// oracle, the reverse of one scan, linear in S.  The port's op had
// recomputed its plain step loop under autograd instead, whose per-step
// slices each write a full-size gradient (quadratic in S); this kernel is
// the port's counterpart of _ss_bwd.  For every batch row b and channel c,
// with the forward h_t = a_t * h_{t-1} + (dt_t x_t) B_t, a_t = exp(dt_t A),
// and the cotangents gy [B, S, d] of y and ghT [B, d, N] of hT:
//
//   lam_t = gy_t C_t + a_{t+1} * lam_{t+1}     (from lam = ghT past S - 1)
//   dC_t[n] = sum_c gy_t h_t          dB_t[n] = sum_c lam_t dt_t x_t
//   dx_t = dt_t sum_n lam_t B_t       ddt_t = x_t sum_n lam_t B_t
//                                             + sum_n lam_t h_{t-1} a_t A
//   dA = sum_{b,t} lam_t h_{t-1} a_t dt_t,     dh0 = a_0 * lam_0
//
// all float32.  Neither the [B, S, d, N] states nor lam exist in device
// memory.
//
// What bounds it on this card: like the forward, bytes and exps nearly
// equally.  Per (b, t, c) it must read dt, x and gy and write ddt and dx
// (20 bytes); per state and step it must take one exp and ~19 float32
// operations.  At Falcon-Mamba-7B's width (d = 8192, N = 16) B = 1,
// S = 4096 moves ~0.67 GB (0.20 ms at 3.35 TB/s) and takes 5.4e8 exps
// (0.13 ms on the special-function units).  dB and dC are sums over all d
// channels, which span blocks.
//
// What the design does about it (a first, simple design: right and linear
// in S, not yet fast):
// - one block per (64 channels, b), 256 threads: each channel's N states
//   split over LANES = 4 adjacent lanes, NP / 4 states a lane (NP = N
//   padded to 4..64), as in the forward;
// - pass 1 re-runs the forward and writes h at the start of every chunk of
//   CH steps into a [B, ceil(S / CH), d, N] checkpoint buffer (each
//   thread its own states, read back only by itself);
// - pass 2 walks the chunks in reverse: it stages the chunk's dt, x, gy,
//   B and C in shared memory, recomputes the chunk's h_t from its
//   checkpoint into registers (CH x NP / 4 a thread), then runs the lam
//   recurrence backwards through the chunk;
// - the sums over a channel's states (for ddt and dx) take the forward's
//   fixed shuffle tree over the 4 lanes; dB and dC are summed over the
//   warp's 8 channels by a reduce-scatter of shuffles (each thread ends
//   with a share of the 2 x NP / 4 sums), over the block's 8 warps in
//   shared memory in warp order, and over the blocks by a second kernel
//   in block order, from per-block partials [2, ceil(d / 64), B, S, N];
//   dA's per-(b, channel) sums over t stay in registers and the second
//   kernel sums them over b in order.  Every sum has a fixed order, so a
//   run is bitwise repeatable;
// - exps are ex2.approx of dt * (A * log2 e), as in the forward, so the
//   recomputed h_t are the forward kernel's bit for bit: each state and
//   step takes three (pass 1, the recompute, the reverse step), where
//   the bound counts one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 4;                      // lanes per channel
constexpr int CHANNELS = 64;                  // channels per block
constexpr int THREADS = CHANNELS * LANES;     // one channel per 4 threads
constexpr int WARPS = THREADS / 32;
constexpr int CG = 32 / LANES;                // channels per warp
constexpr float LOG2E = 1.4426950408889634f;
static_assert(CG == 8, "the dB/dC reduce-scatter runs over 3 xor rounds");

// steps per chunk: the chunk's h_t sit in registers, CH x NP / 4 a thread
__host__ __device__ constexpr int chunk_of(int NP) {
  return NP / LANES * 16 <= 64 ? 16 : 64 / (NP / LANES);
}

template <int NP>
struct Smem {
  static constexpr int CH = chunk_of(NP);
  float dt[CH][CHANNELS];
  float x[CH][CHANNELS];
  float gy[CH][CHANNELS];
  float B[CH][NP];
  float C[CH][NP];
  float ddt[CH][CHANNELS];                    // the chunk's outputs, stored
  float dx[CH][CHANNELS];                     // coalesced after it
  float red[WARPS][CH][2 * NP];               // per-warp dB | dC sums
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Stage steps t0 .. t0 + CH - 1 of the block's channels (dt, x, B; gy and C
// too when ``grads``): rows past S, channels past d, states past N read 0.
template <int NP>
__device__ __forceinline__ void stage(Smem<NP>& sm, const float* dtb,
                                      const float* xb, const float* gyb,
                                      const float* Bb, const float* Cb,
                                      int t0, int S, int c0, int d, int N,
                                      bool grads) {
  constexpr int CH = Smem<NP>::CH;
  for (int i = threadIdx.x; i < CH * CHANNELS; i += THREADS) {
    const int r = i / CHANNELS, v = i % CHANNELS;
    const bool on = t0 + r < S && c0 + v < d;
    const long long o = (long long)(t0 + r) * d + c0 + v;
    sm.dt[r][v] = on ? dtb[o] : 0.f;
    sm.x[r][v] = on ? xb[o] : 0.f;
    if (grads) sm.gy[r][v] = on ? gyb[o] : 0.f;
  }
  for (int i = threadIdx.x; i < CH * NP; i += THREADS) {
    const int r = i / NP, n = i % NP;
    const bool on = t0 + r < S && n < N;
    const long long o = (long long)(t0 + r) * N + n;
    sm.B[r][n] = on ? Bb[o] : 0.f;
    if (grads) sm.C[r][n] = on ? Cb[o] : 0.f;
  }
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 2)
selective_scan_bwd_kernel(const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ x,
                          const float* __restrict__ h0,
                          const float* __restrict__ gy,
                          const float* __restrict__ ghT,
                          float* __restrict__ ddt, float* __restrict__ dx,
                          float* __restrict__ dh0,
                          float* __restrict__ ckpt,
                          float* __restrict__ part,
                          float* __restrict__ dA_part, int Bsz, int S,
                          int d, int N) {
  constexpr int NPL = NP / LANES;             // states per lane
  constexpr int CH = Smem<NP>::CH;
  constexpr int V = 2 * NPL;                  // dB and dC values a thread
  __shared__ Smem<NP> sm;

  const int tid = threadIdx.x;
  const int lane = tid % LANES;               // which quarter of the states
  const int cl = tid / LANES;                 // channel in the block
  const int wl = tid % 32, warp = tid / 32;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CHANNELS;
  const int ch = c0 + cl;
  const bool live = ch < d;
  const int chunks = (S + CH - 1) / CH;

  float a2[NPL], Av[NPL], h[NPL];
  const long long state = ((long long)b * d + ch) * N;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int n = lane * NPL + i;
    const bool on = live && n < N;
    Av[i] = on ? A[(long long)ch * N + n] : 0.f;
    a2[i] = Av[i] * LOG2E;
    h[i] = on ? h0[state + n] : 0.f;
  }

  const long long seq = (long long)b * S;
  const float* dtb = dt + seq * d;
  const float* xb = x + seq * d;
  const float* gyb = gy + seq * d;
  const float* Bb = Bm + seq * N;
  const float* Cb = Cm + seq * N;
  // this thread's checkpoint of chunk k: [B, chunks, d, N]
  auto ck = [&](int k) {
    return ckpt + (((long long)b * chunks + k) * d + ch) * N + lane * NPL;
  };

  // -- pass 1: the forward, h written at every chunk's start --------------
  for (int k = 0; k < chunks; ++k) {
    if (live) {
      float* p = ck(k);
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        if (lane * NPL + i < N) p[i] = h[i];
    }
    if (k + 1 == chunks) break;               // the last chunk's steps are
                                              // recomputed in pass 2 only
    __syncthreads();                          // the last chunk is consumed
    stage<NP>(sm, dtb, xb, gyb, Bb, Cb, k * CH, S, c0, d, N, false);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CH; ++j) {            // a whole chunk: not the last
      const float dtv = sm.dt[j][cl];
      const float dbx = dtv * sm.x[j][cl];
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        h[i] = fmaf(ex2(dtv * a2[i]), h[i], dbx * sm.B[j][lane * NPL + i]);
    }
  }

  // -- pass 2: the chunks in reverse ---------------------------------------
  float mu[NPL], dA_acc[NPL];                 // a_{t+1} lam_{t+1}; dA's sum
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int n = lane * NPL + i;
    mu[i] = live && n < N ? ghT[state + n] : 0.f;
    dA_acc[i] = 0.f;
  }
  const long long blocks = gridDim.x;
  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * CH;
    const int len = min(CH, S - t0);
    __syncthreads();                          // the last chunk is stored
    stage<NP>(sm, dtb, xb, gyb, Bb, Cb, t0, S, c0, d, N, true);
    __syncthreads();
    float hp[NPL];                            // h before the chunk
    {
      const float* p = ck(k);
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        hp[i] = live && lane * NPL + i < N ? p[i] : 0.f;
    }
    float hs[CH][NPL];                        // h_t after step t0 + j
#pragma unroll
    for (int j = 0; j < CH; ++j) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const float prev = j == 0 ? hp[i] : hs[j - 1][i];
        if (j < len) {
          const float dtv = sm.dt[j][cl];
          hs[j][i] = fmaf(ex2(dtv * a2[i]), prev,
                          dtv * sm.x[j][cl] * sm.B[j][lane * NPL + i]);
        } else {
          hs[j][i] = prev;
        }
      }
    }
#pragma unroll
    for (int j = CH - 1; j >= 0; --j) {
      if (j < len) {                          // uniform across the block
        const float dtv = sm.dt[j][cl], xv = sm.x[j][cl];
        const float gv = sm.gy[j][cl];
        const float dbx = dtv * xv;
        float v[V];                           // dB | dC partials
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const int n = lane * NPL + i;
          const float prev = j == 0 ? hp[i] : hs[j - 1][i];
          const float a = ex2(dtv * a2[i]);
          const float lam = fmaf(gv, sm.C[j][n], mu[i]);
          v[i] = lam * dbx;
          v[NPL + i] = gv * hs[j][i];
          s1 = fmaf(lam, sm.B[j][n], s1);
          const float r = lam * prev * a;
          s2 = fmaf(r, Av[i], s2);
          dA_acc[i] = fmaf(r, dtv, dA_acc[i]);
          mu[i] = a * lam;
        }
        // sums over the channel's 4 lanes: (q0 + q2) + (q1 + q3)
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
        if (lane == 0) {
          sm.ddt[j][cl] = fmaf(xv, s1, s2);
          sm.dx[j][cl] = dtv * s1;
        }
        // dB and dC over the warp's 8 channels (lanes 4, 8 and 16 apart):
        // a reduce-scatter, each round halving what a thread keeps while
        // it holds more than one value, then plain sums
        int off = 0, cnt = V;
#pragma unroll
        for (int m = 16; m >= LANES; m >>= 1) {
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
        }
        // value q of this thread: kind (q / NPL: dB, dC), state n
#pragma unroll
        for (int q = 0; q < V; ++q) {
          if (q < cnt) {
            const int g = off + q;
            const int kind = g / NPL, n = lane * NPL + g % NPL;
            sm.red[warp][j][kind * NP + n] = v[q];
          }
        }
      }
    }
    __syncthreads();
    // the chunk's ddt and dx rows, coalesced
    for (int i = tid; i < CH * CHANNELS; i += THREADS) {
      const int r = i / CHANNELS, c = i % CHANNELS;
      if (r < len && c0 + c < d) {
        const long long o = (seq + t0 + r) * d + c0 + c;
        ddt[o] = sm.ddt[r][c];
        dx[o] = sm.dx[r][c];
      }
    }
    // dB and dC over the block's warps, in warp order, into the partials
    // [2, blocks, B, S, N]
    for (int i = tid; i < CH * 2 * NP; i += THREADS) {
      const int r = i / (2 * NP), e = i % (2 * NP);
      const int kind = e / NP, n = e % NP;
      if (r < len && n < N) {
        float s = sm.red[0][r][e];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += sm.red[w][r][e];
        part[(((long long)kind * blocks + blockIdx.x) * Bsz + b) * S * N
             + (long long)(t0 + r) * N + n] = s;
      }
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

// dB and dC: the per-block partials summed in block order; dA: the per-row
// partials summed in row order.
__global__ void __launch_bounds__(256)
selective_scan_bwd_reduce_kernel(const float* __restrict__ part,
                                 const float* __restrict__ dA_part,
                                 float* __restrict__ dB,
                                 float* __restrict__ dC,
                                 float* __restrict__ dA, int blocks, int Bsz,
                                 long long E, long long dN) {
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

template <int NP>
int launch(const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* x, const void* h0, const void* gy, const void* ghT,
           void* ddt, void* dA, void* dB, void* dC, void* dx, void* dh0,
           void* ckpt, void* part, void* dA_part, int B, int S, int d,
           int N, cudaStream_t stream) {
  const int blocks = (d + CHANNELS - 1) / CHANNELS;
  selective_scan_bwd_kernel<NP><<<dim3(blocks, B), THREADS, 0, stream>>>(
      (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)x, (const float*)h0, (const float*)gy,
      (const float*)ghT, (float*)ddt, (float*)dx, (float*)dh0,
      (float*)ckpt, (float*)part, (float*)dA_part, B, S, d, N);
  int code = (int)cudaGetLastError();
  if (code) return code;
  const long long E = (long long)B * S * N, dN = (long long)d * N;
  const long long total = 2 * E + dN;
  selective_scan_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256,
                                     0, stream>>>(
      (const float*)part, (const float*)dA_part, (float*)dB, (float*)dC,
      (float*)dA, blocks, B, E, dN);
  return (int)cudaGetLastError();
}

int padded(int N) {
  int NP = 4;
  while (NP < N) NP *= 2;
  return NP;
}

}  // namespace

// Steps per checkpointed chunk for state size N (the checkpoint buffer is
// [B, ceil(S / chunk), d, N] float32).
extern "C" int selective_scan_bwd_chunk(int N) {
  return chunk_of(padded(N < 1 ? 1 : N));
}

extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* x, const void* h0, const void* gy, const void* ghT,
    void* ddt, void* dA, void* dB, void* dC, void* dx, void* dh0,
    void* ckpt, void* part, void* dA_part, int B, int S, int d, int N,
    void* stream) {
  if (B <= 0 || d <= 0) return 0;
  if (N <= 0 || N > 64 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SSB_LAUNCH(NP)                                                      \
  launch<NP>(dt, A, Bm, Cm, x, h0, gy, ghT, ddt, dA, dB, dC, dx, dh0, ckpt, \
             part, dA_part, B, S, d, N, st)
  switch (padded(N)) {
    case 4: return SSB_LAUNCH(4);
    case 8: return SSB_LAUNCH(8);
    case 16: return SSB_LAUNCH(16);
    case 32: return SSB_LAUNCH(32);
    default: return SSB_LAUNCH(64);
  }
#undef SSB_LAUNCH
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
