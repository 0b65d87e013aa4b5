// Masked, budgeted MCLR local SGD for the federated round, hand-written for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fed_local_sgd.py fed_local_sgd_mclr_fwd
// (_sgd_kernel, pallas_call at :126).  Per cohort client k it runs SGD on
// multinomial logistic regression (logits = xb @ w + b, w: [d, C]) over the
// minibatches idx[k, i, :] for i < n_iters_k, with the closed-form
// softmax-xent gradient and an optional FedProx term against the global
// (w0, b0), and returns the client's params and its mean minibatch loss
// over the executed iterations.  Semantics kept exactly:
//   bmask_b = b < max(n_k, 1)            (batch slot validity, not per index)
//   bsum    = max(sum(bmask), 1)
//   logp    = z - log(sum(exp(z))),  z = logits - max(logits)
//   err     = (exp(logp) - onehot) * bmask / bsum
//   gw = xb^T err,  gb = sum_b err;  + prox_mu * (w - w0), (b - b0)
//   loss_k  = sum(active * loss) / max(cnt, 1)
//
// What bounds it on this card: the per-client loop is serial (iteration i+1
// needs iteration i's params), so the bound is operations: per executed
// iteration ~4 * B * d * C float32 flops for the logits and the gradient.
// The bytes are small beside that: the cohort's x (12.5 MB at FEMNIST
// paper scale) sits in the 50 MB L2.
//
// What the design does about it: one block of 1024 threads per client (the
// TPU ran the clients down its sequential grid); the budget loop runs inside
// the block.  w [d, C], b [C], the batch rows xb [B, d] and the logits/err
// [B, C] live in shared memory for the whole loop (~119 KB at d=784, C=26,
// B=10, so the launch raises the dynamic shared-memory limit).  Batch rows
// are loaded by index from global memory: the Pallas kernel's one-hot
// `sel @ x` gather over the whole staged shard would need the [max_n, d]
// shard on chip, which does not fit for the synthetic set's 2000 x 60 rows.
// The logits' dot products are split over P slices of d so that more than
// B * C threads work; each softmax row is one warp.
//
// The loop stops at min(n_iters_k, max_iters) instead of running all
// max_iters slots: a slot past the budget is `w - lr * 0 * g`, an identity
// update whenever the gradient is finite, so stopping early changes no bit
// of the result for finite data.
//
// No atomics: every sum runs in a fixed order (sequential loops, fixed
// warp-shuffle and shared-memory trees), so results are run-to-run
// deterministic.  One block per client leaves most of the 132 SMs idle at
// K=10; splitting d across a cluster is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kThreads = 1024;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
fed_sgd_kernel(const float* __restrict__ x, const int32_t* __restrict__ y,
               const int32_t* __restrict__ idx, const float* __restrict__ w0,
               const float* __restrict__ b0, const int32_t* __restrict__ ns,
               const int32_t* __restrict__ n_iters,
               float* __restrict__ w_out, float* __restrict__ b_out,
               float* __restrict__ loss_out, int max_n, int d, int C,
               int max_iters, int B, int P, float lr, float prox_mu) {
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const int dC = d * C, BC = B * C;
  float* w = smem;              // [d, C]
  float* b = w + dC;            // [C]
  float* xb = b + C;            // [B, d]
  float* part = xb + B * d;     // [P, B, C] partial logits
  float* err = part + P * BC;   // [B, C] logits, then err
  float* lrow = err + BC;       // [B] masked row nll
  float* red = lrow + B;        // [nt] prox reduction
  int32_t* sidx = reinterpret_cast<int32_t*>(red + nt);   // [B]
  int32_t* ylab = sidx + B;                               // [B]

  const int nk_safe = max(ns[k], 1);
  const int iters = min(max(n_iters[k], 0), max_iters);
  const float bsum = (float)min(B, nk_safe);   // = max(sum(bmask), 1)
  const bool prox = prox_mu != 0.0f;
  const float* xk = x + (long long)k * max_n * d;
  const int32_t* yk = y + (long long)k * max_n;
  const int32_t* idxk = idx + (long long)k * max_iters * B;

  for (int e = tid; e < dC; e += nt) w[e] = w0[e];
  for (int c = tid; c < C; c += nt) b[c] = b0[c];
  float loss_sum = 0.0f;   // kept by thread 0
  __syncthreads();

  const int seg = (d + P - 1) / P;
  for (int i = 0; i < iters; ++i) {
    // batch indices (clamped into the shard, as the reference's gather)
    for (int bb = tid; bb < B; bb += nt) {
      int r = idxk[(long long)i * B + bb];
      r = min(max(r, 0), max_n - 1);
      sidx[bb] = r;
      ylab[bb] = yk[r];
    }
    __syncthreads();
    // batch rows by index from global memory
    for (int e = tid; e < B * d; e += nt) {
      const int bb = e / d, j = e - bb * d;
      xb[e] = xk[(long long)sidx[bb] * d + j];
    }
    __syncthreads();
    // partial logits: slice p of the d-long dot product for output (bb, c)
    for (int u = tid; u < P * BC; u += nt) {
      const int p = u / BC, o = u - p * BC;
      const int bb = o / C, c = o - bb * C;
      const int j1 = min((p + 1) * seg, d);
      const float* xr = xb + bb * d;
      float s = 0.0f;
      for (int j = p * seg; j < j1; ++j) s += xr[j] * w[j * C + c];
      part[u] = s;
    }
    __syncthreads();
    // one warp per batch row: log-softmax with max subtraction, row nll, err
    for (int bb = warp; bb < B; bb += nwarps) {
      float m = -INFINITY;
      for (int c = lane; c < C; c += 32) {
        const int o = bb * C + c;
        float s = part[o];
        for (int p = 1; p < P; ++p) s += part[p * BC + o];
        s += b[c];
        err[o] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float se = 0.0f;
      for (int c = lane; c < C; c += 32) se += expf(err[bb * C + c] - m);
      const float lse = logf(warp_sum(se));
      const float bm = bb < nk_safe ? 1.0f : 0.0f;
      const int yb = ylab[bb];
      float nll = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const int o = bb * C + c;
        const float logp = (err[o] - m) - lse;
        const float oh = c == yb ? 1.0f : 0.0f;
        nll -= logp * oh;
        err[o] = (expf(logp) - oh) * bm / bsum;
      }
      nll = warp_sum(nll);
      if (lane == 0) lrow[bb] = nll * bm;
    }
    __syncthreads();
    // gradient and update; the prox term reads the params before the step
    float dsq = 0.0f;
    for (int e = tid; e < dC; e += nt) {
      const int j = e / C, c = e - j * C;
      float g = 0.0f;
      for (int bb = 0; bb < B; ++bb) g += xb[bb * d + j] * err[bb * C + c];
      const float wv = w[e];
      if (prox) {
        const float dw = wv - w0[e];
        dsq += dw * dw;
        g += prox_mu * dw;
      }
      w[e] = wv - lr * g;
    }
    for (int c = tid; c < C; c += nt) {
      float g = 0.0f;
      for (int bb = 0; bb < B; ++bb) g += err[bb * C + c];
      const float bv = b[c];
      if (prox) {
        const float db = bv - b0[c];
        dsq += db * db;
        g += prox_mu * db;
      }
      b[c] = bv - lr * g;
    }
    if (prox) {   // fixed-shape tree over the block (nt is a power of two)
      red[tid] = dsq;
      __syncthreads();
      for (int s = nt >> 1; s > 0; s >>= 1) {
        if (tid < s) red[tid] += red[tid + s];
        __syncthreads();
      }
    }
    if (tid == 0) {
      float ls = 0.0f;
      for (int bb = 0; bb < B; ++bb) ls += lrow[bb];
      float loss = ls / bsum;
      if (prox) loss += 0.5f * prox_mu * red[0];
      loss_sum += loss;
    }
    __syncthreads();
  }

  float* wk = w_out + (long long)k * dC;
  for (int e = tid; e < dC; e += nt) wk[e] = w[e];
  for (int c = tid; c < C; c += nt) b_out[(long long)k * C + c] = b[c];
  if (tid == 0) loss_out[k] = loss_sum / fmaxf((float)iters, 1.0f);
}

extern "C" long long fed_local_sgd_mclr_smem_bytes(int d, int C, int B, int P) {
  const long long floats = (long long)d * C + C + (long long)B * d +
                           (long long)P * B * C + (long long)B * C + B +
                           kThreads;
  return floats * 4 + 2LL * B * 4;
}

extern "C" int fed_local_sgd_mclr_launch(
    const void* x, const void* y, const void* idx, const void* w0,
    const void* b0, const void* ns, const void* n_iters, void* w_out,
    void* b_out, void* loss_out, int K, int max_n, int d, int C,
    int max_iters, int B, int P, float lr, float prox_mu, void* stream) {
  if (K <= 0) return 0;
  const long long smem = fed_local_sgd_mclr_smem_bytes(d, C, B, P);
  cudaError_t e = cudaFuncSetAttribute(
      fed_sgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fed_sgd_kernel<<<K, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)y, (const int32_t*)idx,
      (const float*)w0, (const float*)b0, (const int32_t*)ns,
      (const int32_t*)n_iters, (float*)w_out, (float*)b_out,
      (float*)loss_out, max_n, d, C, max_iters, B, P, lr, prox_mu);
  return (int)cudaGetLastError();
}

extern "C" const char* fed_local_sgd_mclr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
