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
// What bounds it on this card: bytes, on paper.  Per (b, t, c) it reads dt
// and x and writes y (12 bytes) and does N exps and ~3N flop; at
// Falcon-Mamba-7B's width (d = 8192, N = 16) the exps, 16 per 12 bytes,
// put the special-function units near the memory time, so the scan is close
// to balanced, and its serial chain over t makes latency the practical
// limit.
//
// What the design does about it:
// - one thread per (b, channel) keeps h[N] and A[c, :] in registers for
//   the whole sequence, which replaces the TPU kernel's sequential chunk
//   grid axis with a loop over t inside the thread;
// - 64-thread blocks, so that Falcon's B * d / 64 = 512 blocks spread over
//   all 132 SMs;
// - the sequence goes in chunks of 32 steps: each thread first loads its
//   channel's dt and x for the whole chunk into shared memory (32
//   independent, coalesced loads in flight instead of one per step), and
//   the block stages the chunk's B_t and C_t rows, which every channel
//   reads; then the chunk's steps run from shared memory, and y is stored
//   coalesced across channels;
// - N up to 64, templated on its padded size so h and A stay in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;   // channels per block
constexpr int CH = 32;        // time steps staged per chunk

template <int NP>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ x,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int S, int d, int N) {
  __shared__ float dts[CH][THREADS];
  __shared__ float xs[CH][THREADS];
  __shared__ float Bs[CH][NP];
  __shared__ float Cs[CH][NP];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * THREADS + tid;
  const bool live = ch < d;

  float a[NP], h[NP];
  const long long state = ((long long)b * d + ch) * N;
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    const bool on = live && n < N;
    a[n] = on ? A[(long long)ch * N + n] : 0.f;
    h[n] = on ? h0[state + n] : 0.f;
  }

  const long long seq = (long long)b * S;
  const float* dtb = dt + seq * d;
  const float* xb = x + seq * d;
  float* yb = y + seq * d;
  const float* Bb = Bm + seq * N;
  const float* Cb = Cm + seq * N;

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int len = min(CH, S - t0);
    __syncthreads();                     // the previous chunk is consumed
    if (live) {
      for (int t = 0; t < len; ++t) {
        dts[t][tid] = dtb[(long long)(t0 + t) * d + ch];
        xs[t][tid] = xb[(long long)(t0 + t) * d + ch];
      }
    }
    for (int i = tid; i < len * NP; i += THREADS) {
      const int t = i / NP, n = i % NP;
      const long long o = (long long)(t0 + t) * N + n;
      Bs[t][n] = n < N ? Bb[o] : 0.f;
      Cs[t][n] = n < N ? Cb[o] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < len; ++t) {
      const float dtv = dts[t][tid];
      const float dbx = dtv * xs[t][tid];
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        if (n < N) {
          h[n] = expf(dtv * a[n]) * h[n] + dbx * Bs[t][n];
          yv = fmaf(h[n], Cs[t][n], yv);
        }
      }
      yb[(long long)(t0 + t) * d + ch] = yv;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < N) hT[state + n] = h[n];
  }
}

template <int NP>
int launch(const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* x, const void* h0, void* y, void* hT, int B, int S,
           int d, int N, cudaStream_t stream) {
  const dim3 grid((d + THREADS - 1) / THREADS, B);
  selective_scan_kernel<NP><<<grid, THREADS, 0, stream>>>(
      (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)x, (const float*)h0, (float*)y, (float*)hT, S, d, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_fwd_launch(const void* dt, const void* A,
                                         const void* Bm, const void* Cm,
                                         const void* x, const void* h0,
                                         void* y, void* hT, int B, int S,
                                         int d, int N, void* stream) {
  if (B <= 0 || d <= 0) return 0;
  if (N <= 0 || N > 64 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 4) return launch<4>(dt, A, Bm, Cm, x, h0, y, hT, B, S, d, N, st);
  if (N <= 8) return launch<8>(dt, A, Bm, Cm, x, h0, y, hT, B, S, d, N, st);
  if (N <= 16) return launch<16>(dt, A, Bm, Cm, x, h0, y, hT, B, S, d, N, st);
  if (N <= 32) return launch<32>(dt, A, Bm, Cm, x, h0, y, hT, B, S, d, N, st);
  return launch<64>(dt, A, Bm, Cm, x, h0, y, hT, B, S, d, N, st);
}

extern "C" const char* selective_scan_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
