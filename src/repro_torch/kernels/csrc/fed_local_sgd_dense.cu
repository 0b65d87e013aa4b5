// Masked, budgeted two-layer (tanh MLP) local SGD for the federated round,
// hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fed_local_sgd_dense.py fed_local_sgd_dense_fwd
// (_dense_sgd_kernel, pallas_call at :154).  Per cohort client k it runs SGD
// on h = tanh(xb w1 + b1), logits = h w2 + b2 over the minibatches
// idx[k, i, :] for i < n_iters_k, with the reference's hand-written
// backprop and an optional FedProx term on all four leaves, and returns the
// client's params and its mean minibatch loss over executed iterations:
//   bmask_b = b < max(n_k, 1),  bsum = max(sum(bmask), 1)
//   err     = (softmax(logits) - onehot) * bmask / bsum
//   gw2 = h^T err,  gb2 = sum_b err
//   dpre    = (err w2^T) * (1 - h^2)            (with the pre-step w2)
//   gw1 = xb^T dpre, gb1 = sum_b dpre;  + prox_mu * (p - p0) on each leaf
//   loss_k  = sum(executed losses) / max(iters, 1)
//
// What bounds it on this card: the per-client loop is serial, so the bound
// is operations, ~(4 B d H + 6 B H C) float32 flops per executed iteration
// (the first layer's forward and gw1 dominate).  The bytes are small beside
// that: the cohort's x and the clients' w1 sit in the 50 MB L2.
//
// What the design does about it: one block of 1024 threads per client (the
// TPU ran the clients down its sequential grid); the budget loop runs
// inside the block.  The Pallas kernel kept all four leaves in VMEM.  A
// Hopper block has 227 KB of shared memory and at FEMNIST w1 alone is
// 784 x 64 x 4 = 200,704 B, so w1 lives in global memory instead: in the
// client's own output slice w1_out[k], copied from the global w1 and updated
// in place, each element by one owning thread in a fixed order (10 clients
// x 196 KB stays in L2).  The batch rows xb [B, d], w2, the biases, the
// first layer's partial sums, h, dpre, logits/err and the prox reduction
// live in shared memory (~90 KB at FEMNIST, so the launch raises the
// dynamic limit).  Batch rows are loaded by index from global memory, as in
// fed_local_sgd.cu; the Pallas kernel's one-hot `sel @ x` is not carried
// over (the synthetic set's 2000 x 60 shard would not fit on chip).  The
// first layer's d-long dots are split over S slices of d, S = 1024 / H at
// H = 64, each thread keeping up to 16 batch rows' sums in registers so a
// w1 element is read once per chunk of 16 rows.  Each softmax row is one
// warp.  Splitting w1 over a thread-block cluster (distributed shared
// memory) and wgmma for the three B x d x H products are later work.
//
// The loop stops at min(n_iters_k, max_iters) instead of running all
// max_iters slots: a slot past the budget is `p - lr * 0 * g`, an identity
// update whenever the gradient is finite, so stopping early changes no bit
// of the result for finite data (the same rule as fed_local_sgd.cu).
//
// No atomics: every sum runs in a fixed order (sequential loops, fixed
// warp-shuffle and shared-memory trees), so results are run-to-run
// deterministic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kThreads = 1024;
constexpr int kRowChunk = 16;   // batch rows summed per pass of layer 1

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
fed_dense_sgd_kernel(const float* __restrict__ x, const int32_t* __restrict__ y,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ w10,
                     const float* __restrict__ b10,
                     const float* __restrict__ w20,
                     const float* __restrict__ b20,
                     const int32_t* __restrict__ ns,
                     const int32_t* __restrict__ n_iters,
                     float* __restrict__ w1_out, float* __restrict__ b1_out,
                     float* __restrict__ w2_out, float* __restrict__ b2_out,
                     float* __restrict__ loss_out, int max_n, int d, int H,
                     int C, int max_iters, int B, int S, float lr,
                     float prox_mu) {
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const int dH = d * H, HC = H * C, BH = B * H, BC = B * C;
  float* xb = smem;             // [B, d]
  float* w2 = xb + B * d;       // [H, C]
  float* b1 = w2 + HC;          // [H]
  float* b2 = b1 + H;           // [C]
  float* part = b2 + C;         // [S, B, H] first-layer partial sums
  float* hid = part + S * BH;   // [B, H] h
  float* dpre = hid + BH;       // [B, H]
  float* err = dpre + BH;       // [B, C] logits, then err
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
  float* w1 = w1_out + (long long)k * dH;   // this client's w1, in place

  for (int e = tid; e < dH; e += nt) w1[e] = w10[e];
  for (int e = tid; e < HC; e += nt) w2[e] = w20[e];
  for (int h = tid; h < H; h += nt) b1[h] = b10[h];
  for (int c = tid; c < C; c += nt) b2[c] = b20[c];
  float loss_sum = 0.0f;   // kept by thread 0
  __syncthreads();

  const int seg = (d + S - 1) / S;
  for (int i = 0; i < iters; ++i) {
    // batch indices (clamped into the shard, as the reference's gather)
    for (int bb = tid; bb < B; bb += nt) {
      int r = idxk[(long long)i * B + bb];
      r = min(max(r, 0), max_n - 1);
      sidx[bb] = r;
      ylab[bb] = yk[r];
    }
    __syncthreads();
    for (int e = tid; e < B * d; e += nt) {
      const int bb = e / d, j = e - bb * d;
      xb[e] = xk[(long long)sidx[bb] * d + j];
    }
    __syncthreads();
    // layer 1, partial: slice s of the d-long dots of column h, for every
    // batch row (a w1 element is read once per chunk of kRowChunk rows)
    for (int u = tid; u < S * H; u += nt) {
      const int s = u / H, h = u - s * H;
      const int j0 = s * seg, j1 = min(j0 + seg, d);
      for (int r0 = 0; r0 < B; r0 += kRowChunk) {
        float acc[kRowChunk];
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.0f;
        for (int j = j0; j < j1; ++j) {
          const float wv = w1[j * H + h];
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r)
            if (r0 + r < B) acc[r] += xb[(r0 + r) * d + j] * wv;
        }
#pragma unroll
        for (int r = 0; r < kRowChunk; ++r)
          if (r0 + r < B) part[(s * B + r0 + r) * H + h] = acc[r];
      }
    }
    __syncthreads();
    // h = tanh(sum of the slices in order + b1)
    for (int o = tid; o < BH; o += nt) {
      float v = part[o];
      for (int s = 1; s < S; ++s) v += part[s * BH + o];
      hid[o] = tanhf(v + b1[o % H]);
    }
    __syncthreads();
    // logits = h w2 + b2
    for (int o = tid; o < BC; o += nt) {
      const int bb = o / C, c = o - bb * C;
      const float* hr = hid + bb * H;
      float v = 0.0f;
      for (int h = 0; h < H; ++h) v += hr[h] * w2[h * C + c];
      err[o] = v + b2[c];
    }
    __syncthreads();
    // one warp per batch row: log-softmax with max subtraction, nll, err
    for (int bb = warp; bb < B; bb += nwarps) {
      float m = -INFINITY;
      for (int c = lane; c < C; c += 32) m = fmaxf(m, err[bb * C + c]);
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
    // dpre = (err w2^T) * (1 - h^2), with the pre-step w2
    for (int o = tid; o < BH; o += nt) {
      const int bb = o / H, h = o - bb * H;
      const float* er = err + bb * C;
      const float* wr = w2 + h * C;
      float v = 0.0f;
      for (int c = 0; c < C; ++c) v += er[c] * wr[c];
      const float hv = hid[o];
      dpre[o] = v * (1.0f - hv * hv);
    }
    __syncthreads();
    // gradients and updates; the prox term reads the params before the step
    float dsq = 0.0f;
    for (int e = tid; e < dH; e += nt) {
      const int j = e / H, h = e - j * H;
      float g = 0.0f;
      for (int bb = 0; bb < B; ++bb) g += xb[bb * d + j] * dpre[bb * H + h];
      const float wv = w1[e];
      if (prox) {
        const float dw = wv - w10[e];
        dsq += dw * dw;
        g += prox_mu * dw;
      }
      w1[e] = wv - lr * g;
    }
    for (int h = tid; h < H; h += nt) {
      float g = 0.0f;
      for (int bb = 0; bb < B; ++bb) g += dpre[bb * H + h];
      const float bv = b1[h];
      if (prox) {
        const float db = bv - b10[h];
        dsq += db * db;
        g += prox_mu * db;
      }
      b1[h] = bv - lr * g;
    }
    for (int e = tid; e < HC; e += nt) {
      const int h = e / C, c = e - h * C;
      float g = 0.0f;
      for (int bb = 0; bb < B; ++bb) g += hid[bb * H + h] * err[bb * C + c];
      const float wv = w2[e];
      if (prox) {
        const float dw = wv - w20[e];
        dsq += dw * dw;
        g += prox_mu * dw;
      }
      w2[e] = wv - lr * g;
    }
    for (int c = tid; c < C; c += nt) {
      float g = 0.0f;
      for (int bb = 0; bb < B; ++bb) g += err[bb * C + c];
      const float bv = b2[c];
      if (prox) {
        const float db = bv - b20[c];
        dsq += db * db;
        g += prox_mu * db;
      }
      b2[c] = bv - lr * g;
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

  for (int h = tid; h < H; h += nt) b1_out[(long long)k * H + h] = b1[h];
  for (int e = tid; e < HC; e += nt) w2_out[(long long)k * HC + e] = w2[e];
  for (int c = tid; c < C; c += nt) b2_out[(long long)k * C + c] = b2[c];
  if (tid == 0) loss_out[k] = loss_sum / fmaxf((float)iters, 1.0f);
}

extern "C" long long fed_local_sgd_dense_smem_bytes(int d, int H, int C,
                                                    int B, int S) {
  const long long floats = (long long)B * d + (long long)H * C + H + C +
                           (long long)S * B * H + 2LL * B * H +
                           (long long)B * C + B + kThreads;
  return floats * 4 + 2LL * B * 4;
}

extern "C" int fed_local_sgd_dense_launch(
    const void* x, const void* y, const void* idx, const void* w10,
    const void* b10, const void* w20, const void* b20, const void* ns,
    const void* n_iters, void* w1_out, void* b1_out, void* w2_out,
    void* b2_out, void* loss_out, int K, int max_n, int d, int H, int C,
    int max_iters, int B, int S, float lr, float prox_mu, void* stream) {
  if (K <= 0) return 0;
  const long long smem = fed_local_sgd_dense_smem_bytes(d, H, C, B, S);
  cudaError_t e = cudaFuncSetAttribute(
      fed_dense_sgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fed_dense_sgd_kernel<<<K, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)y, (const int32_t*)idx,
      (const float*)w10, (const float*)b10, (const float*)w20,
      (const float*)b20, (const int32_t*)ns, (const int32_t*)n_iters,
      (float*)w1_out, (float*)b1_out, (float*)w2_out, (float*)b2_out,
      (float*)loss_out, max_n, d, H, C, max_iters, B, S, lr, prox_mu);
  return (int)cudaGetLastError();
}

extern "C" const char* fed_local_sgd_dense_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
