// Masked, budgeted MCLR local SGD for the federated round, hand-written for
// Hopper (sm_90a), one thread-block cluster per client.
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
// needs iteration i's params), so a client's chain of steps sets the time.
// One step is ~4 * B * d * C float32 flops (0.82 MFLOP at FEMNIST); the
// cohort's x (12.5 MB at FEMNIST paper scale) sits in the 50 MB L2.  What is
// left to pay per step is latency: the dependent phases of one step and the
// barriers between them.
//
// What the design does about it: one cluster of CS CTAs per client
// (``fed_local_sgd.py`` chooses CS: at most 8, K * CS <= 132 where K
// allows).  CTA r of the cluster owns rows [r R, r R + R) of w (R a
// multiple of 4) and keeps them, and w0's when FedProx is on, in shared
// memory for the whole loop; b is replicated in every CTA.  A step:
//   1. the step's batch rows (this CTA's slice of them), labels and the
//      next step's indices were fetched with cp.async during the step
//      before (double-buffered): wait, barrier;
//   2. partial logits over the own rows, [B, C]: one warp per batch row,
//      lane -> c, the rows read as float4 in four chains (a warp-per-quad
//      split would need a second barrier and a sum over the warps, which
//      cost more than they save: every phase here is a chain of
//      shared-memory loads, not arithmetic); each warp publishes its row
//      straight into this CTA's shared memory (two buffers by step parity,
//      so that one cluster barrier a step is enough), and the warps
//      without a batch row fetch the next step's rows meanwhile;
//   3. one cluster barrier (a block barrier when CS = 1); then one warp
//      per batch row reads the CS partials through distributed shared
//      memory and adds them in rank order, so every CTA gets the same
//      logits bit for bit, and runs the softmax, the row nll and err
//      itself;
//   4. barrier; each CTA updates its own rows of w from its own slice of
//      the batch (lane -> c, warp -> a run of row quads, err and a quad's
//      batch rows in registers, loaded before use) and its replica of b
//      (every CTA the same arithmetic, so the replicas stay equal).
// The FedProx loss needs the cluster-wide sum of (p - p0)^2 over the
// pre-step params; only the loss reads it, so each CTA publishes its share
// with the next step's partials (rank 0 counts the replicated b) and rank 0
// adds the step's loss one step late; after the loop one more cluster
// barrier carries the last step's share, and a final one keeps every CTA
// resident until rank 0 has read it.
//
// The loop stops at min(n_iters_k, max_iters) instead of running all
// max_iters slots: a slot past the budget is `w - lr * 0 * g`, an identity
// update whenever the gradient is finite, so stopping early changes no bit
// of the result for finite data.
//
// No atomics: every sum runs in a fixed order (sequential loops, warps in
// warp order, ranks in rank order, fixed xor-shuffle trees), so two launches
// on the same inputs give the same bits.  The order depends on CS, so
// results at two cluster sizes agree within the tolerance, not bitwise.

#include "fed_sgd_cluster.cuh"

// Shared-memory layout, in floats (each segment 16-byte aligned).  R rows
// of w (and of w0 with prox), the batch rows [2][BP][R] (BP = B padded to
// whole register chunks), the published partial logits [2][B*C + 1] (the
// last slot carries the FedProx share), logits/err [BP][C], b and b0, the
// row losses [BP], the warps' FedProx shares, then int32 labels [2][B] and
// indices [2][B].
struct Layout {
  long long w, w0, xb, pub, err, bv, b0, lrow, rdsq, ylab, sidx, total;
  long long pub_stride;
  __host__ __device__ Layout(int C, int B, int R, int nw, bool prox) {
    const int BP = padded_rows(B);
    pub_stride = align4((long long)B * C + 1);
    long long o = 0;
    w = o;    o += align4((long long)R * C);
    w0 = o;   o += prox ? align4((long long)R * C) : 0;
    xb = o;   o += align4(2LL * BP * R);
    pub = o;  o += 2 * pub_stride;
    err = o;  o += align4((long long)BP * C);
    bv = o;   o += align4(C);
    b0 = o;   o += align4(C);
    lrow = o; o += align4(BP);
    rdsq = o; o += align4(nw);
    ylab = o; o += align4(2LL * B);
    sidx = o; o += align4(2LL * B);
    total = o;
  }
};

template <int RB>
__global__ void __launch_bounds__(kMaxThreads, 1)
fed_sgd_cluster_kernel(const float* __restrict__ x,
                       const int32_t* __restrict__ y,
                       const int32_t* __restrict__ idx,
                       const float* __restrict__ w0g,
                       const float* __restrict__ b0g,
                       const int32_t* __restrict__ ns,
                       const int32_t* __restrict__ n_iters,
                       float* __restrict__ w_out, float* __restrict__ b_out,
                       float* __restrict__ loss_out, int max_n, int d, int C,
                       int max_iters, int B, int R, float lr, float prox_mu) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int k = blockIdx.x / CS;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const bool prox = prox_mu != 0.0f;
  const Layout L(C, B, R, nw, prox);
  float* w = smem + L.w;
  float* w0 = smem + L.w0;
  float* xb = smem + L.xb;
  float* pub = smem + L.pub;
  float* err = smem + L.err;
  float* bv = smem + L.bv;
  float* b0 = smem + L.b0;
  float* lrow = smem + L.lrow;
  float* rdsq = smem + L.rdsq;
  int32_t* ylab = reinterpret_cast<int32_t*>(smem + L.ylab);
  int32_t* sidx = reinterpret_cast<int32_t*>(smem + L.sidx);

  const int BP = padded_rows(B);
  const int R4 = R >> 2;
  const int r0 = rank * R;
  const int nloc = max(min(R, d - r0), 0);   // this CTA's rows of w
  const int nq = (nloc + 3) >> 2;             // row quads (pad rows zero)
  const int qw = (R4 + nw - 1) / nw;          // quads per warp
  const int nwa = (nq + qw - 1) / qw;         // warps that hold rows
  const int q0 = warp * qw, q1 = min(q0 + qw, nq);
  const int BC = B * C;
  const int nk_safe = max(ns[k], 1);
  const int iters = min(max(n_iters[k], 0), max_iters);
  const float bsum = (float)min(B, nk_safe);   // = max(sum(bmask), 1)
  const float* xk = x + (long long)k * max_n * d;
  const int32_t* yk = y + (long long)k * max_n;
  const int32_t* idxk = idx + (long long)k * max_iters * B;
  const bool vec = (d & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // the warps that have no batch row in the partial phase fetch the next
  // step's rows there; with none, every thread fetches after the step's
  // first barrier
  const bool spare_warps_fetch = nw > B;
  // the last thread keeps the books: it publishes this CTA's FedProx share
  // and, on rank 0, the loss; its warp has the fewest rows of w and no
  // batch row (when nw > B), so this work stays off the longest path
  const bool acct = tid == nt - 1;

  for (int e = tid; e < R * C; e += nt) {
    const float v = e / C < nloc ? w0g[(long long)r0 * C + e] : 0.0f;
    w[e] = v;
    if (prox) w0[e] = v;
  }
  for (int c = tid; c < C; c += nt) {
    bv[c] = b0g[c];
    b0[c] = b0g[c];
  }
  for (int e = tid; e < 2 * BP * R; e += nt) xb[e] = 0.0f;
  for (int e = tid; e < BP * C; e += nt) err[e] = 0.0f;
  for (int e = tid; e < BP; e += nt) lrow[e] = 0.0f;
  for (int e = tid; e < nw; e += nt) rdsq[e] = 0.0f;
  if (iters > 0)
    for (int bb = tid; bb < B; bb += nt) sidx[bb] = idxk[bb];
  __syncthreads();

  auto cluster_barrier = [&]() {
    if (CS > 1)
      cluster.sync();
    else
      __syncthreads();
  };
  auto peer = [&](float* p, int r) {   // rank r's copy of a buffer
    return CS > 1 ? cluster.map_shared_rank(p, r) : p;
  };
  const RowFetch fetch{xk, yk, idxk, xb, ylab, sidx, max_n, d,
                       B,  BP, R,    r0, nloc, iters, vec};
  if (iters > 0) fetch(0, tid, nt);

  float loss_sum = 0.0f, pending = 0.0f;   // kept by rank 0's accountant
  for (int i = 0; i < iters; ++i) {
    const int cur = i & 1;
    cp_async_wait_all();
    __syncthreads();
    if (!spare_warps_fetch && i + 1 < iters) fetch(i + 1, tid, nt);
    const float4* xc4 = reinterpret_cast<const float4*>(xb + cur * BP * R);

    // partial logits over the own rows, one warp per batch row (lane ->
    // c, four chains over the rows mod 4), published straight into this
    // CTA's buffer for the step's parity; the last slot carries the
    // previous step's FedProx share; the warps without a batch row fetch
    // the next step's rows meanwhile
    float* pb = pub + cur * L.pub_stride;
    for (int bb = warp; bb < B; bb += nw) {
      const float4* xr = xc4 + bb * R4;
      for (int cb = 0; cb < C; cb += 32) {
        const int c = cb + lane;
        const float* wc = w + min(c, C - 1);   // lanes past C never store
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
        for (int q = 0; q < nq; ++q) {
          const float4 xv = xr[q];
          const float* wq = wc + 4 * q * C;
          a0 = fmaf(xv.x, wq[0], a0);
          a1 = fmaf(xv.y, wq[C], a1);
          a2 = fmaf(xv.z, wq[2 * C], a2);
          a3 = fmaf(xv.w, wq[3 * C], a3);
        }
        if (c < C) pb[bb * C + c] = (a0 + a1) + (a2 + a3);
      }
    }
    if (spare_warps_fetch && warp >= B && i + 1 < iters)
      fetch(i + 1, tid - 32 * B, nt - 32 * B);
    if (acct) pb[BC] = warps_sum(rdsq, nw);
    cluster_barrier();

    if (rank == 0 && acct && i > 0) {   // the previous step's loss
      float loss = pending;
      if (prox) {
        float s = 0.0f;
        for (int r = 0; r < CS; ++r) s += peer(pb, r)[BC];
        loss += 0.5f * prox_mu * s;
      }
      loss_sum += loss;
    }
    // one warp per batch row: the ranks' partials in rank order, + b, then
    // log-softmax with max subtraction, row nll, err
    for (int bb = warp; bb < B; bb += nw) {
      float m = -INFINITY;
      for (int c = lane; c < C; c += 32) {
        const int o = bb * C + c;
        float v[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          if (r < CS) v[r] = peer(pb, r)[o];
        float s = v[0];
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r)
          if (r < CS) s += v[r];
        s += bv[c];
        err[o] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float se = 0.0f;
      for (int c = lane; c < C; c += 32) se += expf(err[bb * C + c] - m);
      const float lse = logf(warp_sum(se));
      const float bm = bb < nk_safe ? 1.0f : 0.0f;
      const int yb = ylab[cur * B + bb];
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

    // gradient and update of the own rows (lane -> c, warp -> row quads,
    // err in registers); the prox term reads the params before the step
    float dsq = 0.0f;
    if (warp < nwa) {
      for (int cb = 0; cb < C; cb += 32) {
        const int c = cb + lane;
        if (c >= C) continue;
        float ev[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) ev[r] = err[r * C + c];
        for (int q = q0; q < q1; ++q) {
          float4 xv[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) xv[r] = xc4[r * R4 + q];
          float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            g[0] = fmaf(xv[r].x, ev[r], g[0]);
            g[1] = fmaf(xv[r].y, ev[r], g[1]);
            g[2] = fmaf(xv[r].z, ev[r], g[2]);
            g[3] = fmaf(xv[r].w, ev[r], g[3]);
          }
          for (int bb = RB; bb < B; ++bb) {
            const float4 xr = xc4[bb * R4 + q];
            const float e = err[bb * C + c];
            g[0] = fmaf(xr.x, e, g[0]);
            g[1] = fmaf(xr.y, e, g[1]);
            g[2] = fmaf(xr.z, e, g[2]);
            g[3] = fmaf(xr.w, e, g[3]);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int e = (4 * q + jj) * C + c;
            const float wv = w[e];
            float gj = g[jj];
            if (prox) {
              const float dw = wv - w0[e];
              dsq += dw * dw;
              gj += prox_mu * dw;
            }
            w[e] = wv - lr * gj;
          }
        }
      }
    }
    for (int c = lane; warp == nw - 1 && c < C; c += 32) {   // replicated b
      float ev[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) ev[r] = err[r * C + c];
      float g = 0.0f;
#pragma unroll
      for (int r = 0; r < RB; ++r) g += ev[r];
      for (int bb = RB; bb < B; ++bb) g += err[bb * C + c];
      const float v = bv[c];
      if (prox) {
        const float db = v - b0[c];
        if (rank == 0) dsq += db * db;
        g += prox_mu * db;
      }
      bv[c] = v - lr * g;
    }
    if (prox) {
      dsq = warp_sum(dsq);
      if (lane == 0) rdsq[warp] = dsq;
    }
    if (rank == 0 && acct) {
      float lv[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) lv[r] = lrow[r];
      float ls = 0.0f;
#pragma unroll
      for (int r = 0; r < RB; ++r) ls += lv[r];
      for (int bb = RB; bb < B; ++bb) ls += lrow[bb];
      pending = ls / bsum;
    }
  }

  // the last step's FedProx share, then its loss
  __syncthreads();
  float* pb = pub + (iters & 1) * L.pub_stride;
  if (acct) pb[BC] = warps_sum(rdsq, nw);
  cluster_barrier();
  if (rank == 0 && acct) {
    if (iters > 0) {
      float loss = pending;
      if (prox) {
        float s = 0.0f;
        for (int r = 0; r < CS; ++r) s += peer(pb, r)[BC];
        loss += 0.5f * prox_mu * s;
      }
      loss_sum += loss;
    }
    loss_out[k] = loss_sum / fmaxf((float)iters, 1.0f);
  }
  float* wk = w_out + (long long)k * d * C + (long long)r0 * C;
  for (int e = tid; e < nloc * C; e += nt) wk[e] = w[e];
  if (rank == 0)
    for (int c = tid; c < C; c += nt) b_out[(long long)k * C + c] = bv[c];
  cluster_barrier();   // no CTA leaves while rank 0 reads its shared memory
}

typedef void (*SgdKernel)(const float*, const int32_t*, const int32_t*,
                          const float*, const float*, const int32_t*,
                          const int32_t*, float*, float*, float*, int, int,
                          int, int, int, int, float, float);

static SgdKernel pick_kernel(int B) {
  switch (rows_in_registers(B)) {
    case 4: return fed_sgd_cluster_kernel<4>;
    case 10: return fed_sgd_cluster_kernel<10>;
    default: return fed_sgd_cluster_kernel<16>;
  }
}

extern "C" long long fed_local_sgd_mclr_smem_bytes(int C, int B, int R,
                                                   int nw, int prox) {
  return Layout(C, B, R, nw, prox != 0).total * 4;
}

// How many clusters of CS CTAs (nw warps, smem bytes each) can be resident
// at once; a negative value is a CUDA error code.
extern "C" int fed_local_sgd_mclr_max_clusters(int B, int CS, int nw,
                                               long long smem) {
  return max_active_clusters(pick_kernel(B), CS, nw, smem);
}

extern "C" int fed_local_sgd_mclr_launch(
    const void* x, const void* y, const void* idx, const void* w0,
    const void* b0, const void* ns, const void* n_iters, void* w_out,
    void* b_out, void* loss_out, int K, int max_n, int d, int C,
    int max_iters, int B, int CS, int R, int nw, float lr, float prox_mu,
    void* stream) {
  if (K <= 0) return 0;
  const long long smem = Layout(C, B, R, nw, prox_mu != 0.0f).total * 4;
  return launch_clusters(
      pick_kernel(B), K, CS, nw, smem, stream, (const float*)x,
      (const int32_t*)y, (const int32_t*)idx, (const float*)w0,
      (const float*)b0, (const int32_t*)ns, (const int32_t*)n_iters,
      (float*)w_out, (float*)b_out, (float*)loss_out, max_n, d, C,
      max_iters, B, R, lr, prox_mu);
}

extern "C" const char* fed_local_sgd_mclr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
