// Masked, budgeted two-layer (tanh MLP) local SGD for the federated round,
// hand-written for Hopper (sm_90a), one thread-block cluster per client.
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
// What bounds it on this card: the per-client loop is serial, so a client's
// chain of steps sets the time.  One step is ~(4 B d H + 6 B H C) float32
// flops (2.0 MFLOP at FEMNIST; the first layer's forward and gw1 dominate);
// the cohort's x sits in the 50 MB L2.  What is left to pay per step is
// latency: the dependent phases of one step and the barriers between them.
//
// What the design does about it: one cluster of CS CTAs per client
// (``fed_local_sgd_dense.py`` chooses CS: at most 8, K * CS <= 132 where K
// allows, and enough for w1's rows to fit).  At FEMNIST w1 is 784 x 64 x 4
// = 200,704 B, more than a block's 227 KB beside the rest; split over the
// cluster, CTA r owns rows [r R, r R + R) of w1 (R a multiple of 4; 25 KB
// at CS = 8) and keeps them, and w10's with FedProx, in shared memory for
// the whole loop, so w1 leaves global memory until the final write of
// w1_out[k].  b1, w2 and b2 are replicated in every CTA.  A step:
//   1. the step's batch rows (this CTA's slice of them), labels and the
//      next step's indices were fetched with cp.async during the step
//      before (double-buffered): wait, barrier;
//   2. the first layer's partial sums over the own rows, [B, H]: one warp
//      per batch row, lane -> h (two per lane per 64), the rows read as
//      float4 in four chains (a warp-per-quad split would need a second
//      barrier and a sum over the warps, which cost more than they save:
//      every phase here is a chain of shared-memory loads, not
//      arithmetic); each warp publishes its row straight into this CTA's
//      shared memory (two buffers by step parity, so that one cluster
//      barrier a step is enough), and the warps without a batch row fetch
//      the next step's rows meanwhile;
//   3. one cluster barrier (a block barrier when CS = 1); then one warp
//      per batch row reads the CS partials through distributed shared
//      memory and adds them in rank order (so every CTA gets the same
//      bits), and runs the small tail itself: tanh, h w2 + b2 (four
//      chains over h), the softmax, err and dpre (two chains over c), with
//      only __syncwarp between them;
//   4. barrier; each CTA updates its own rows of w1 from its own slice of
//      the batch (lane -> h, warp -> a run of row quads, dpre and a quad's
//      batch rows in registers, loaded before use) and its replicas of b1,
//      w2 and b2
//      (every CTA the same arithmetic, so the replicas stay equal).
// The FedProx loss needs the cluster-wide sum of (p - p0)^2 over the
// pre-step params; each CTA publishes its share with the next step's
// partials (rank 0 counts the replicated leaves) and rank 0 adds the
// step's loss one step late; after the loop one more cluster barrier
// carries the last step's share, and a final one keeps every CTA resident
// until rank 0 has read it.
//
// The loop stops at min(n_iters_k, max_iters) instead of running all
// max_iters slots: a slot past the budget is `p - lr * 0 * g`, an identity
// update whenever the gradient is finite, so stopping early changes no bit
// of the result for finite data (the same rule as fed_local_sgd.cu).
//
// No atomics: every sum runs in a fixed order (sequential loops, warps in
// warp order, ranks in rank order, fixed xor-shuffle trees), so two launches
// on the same inputs give the same bits.  The order depends on CS, so
// results at two cluster sizes agree within the tolerance, not bitwise.

#include "fed_sgd_cluster.cuh"

// w2's row stride in shared memory: odd, so that a warp reading a column of
// w2 (lane -> h, in dpre) hits 32 banks
__host__ __device__ inline int w2_stride(int C) { return C | 1; }

// Shared-memory layout, in floats (each segment 16-byte aligned).  R rows
// of w1 (and of w10 with prox), the batch rows [2][BP][R] (BP = B padded
// to whole register chunks), the published first-layer partials
// [2][B*H + 1] (the last slot carries the FedProx share), w2 [H][C|1] (and
// w20 with prox), b1, b10, b2, b20, h and dpre [BP][H], logits/err
// [BP][C], the row losses [BP], the warps' FedProx shares, then int32
// labels [2][B] and indices [2][B].
struct Layout {
  long long w1, w10, xb, pub, w2, w20, b1, b10, b2, b20, hid, dpre, err, lrow,
      rdsq, ylab, sidx, total;
  long long pub_stride;
  __host__ __device__ Layout(int H, int C, int B, int R, int nw, bool prox) {
    const int BP = padded_rows(B);
    const long long w2n = align4((long long)H * w2_stride(C));
    pub_stride = align4((long long)B * H + 1);
    long long o = 0;
    w1 = o;   o += align4((long long)R * H);
    w10 = o;  o += prox ? align4((long long)R * H) : 0;
    xb = o;   o += align4(2LL * BP * R);
    pub = o;  o += 2 * pub_stride;
    w2 = o;   o += w2n;
    w20 = o;  o += prox ? w2n : 0;
    b1 = o;   o += align4(H);
    b10 = o;  o += align4(H);
    b2 = o;   o += align4(C);
    b20 = o;  o += align4(C);
    hid = o;  o += align4((long long)BP * H);
    dpre = o; o += align4((long long)BP * H);
    err = o;  o += align4((long long)BP * C);
    lrow = o; o += align4(BP);
    rdsq = o; o += align4(nw);
    ylab = o; o += align4(2LL * B);
    sidx = o; o += align4(2LL * B);
    total = o;
  }
};

__device__ __forceinline__ void sgd_update(float* p, const float* p0,
                                           float g, bool prox, bool count,
                                           float lr, float prox_mu,
                                           float& dsq) {
  const float v = *p;
  if (prox) {
    const float dv = v - *p0;
    if (count) dsq += dv * dv;
    g += prox_mu * dv;
  }
  *p = v - lr * g;
}

// sum_b a[b * sa] * c[b * sc] over the B rows, in order (rows RB.. from
// shared memory one at a time; the first RB loaded before any is used)
template <int RB>
__device__ __forceinline__ float row_dot(const float* a, int sa,
                                         const float* c, int sc, int B) {
  float av[RB], cv[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    av[r] = a[r * sa];
    cv[r] = c[r * sc];
  }
  float g = 0.0f;
#pragma unroll
  for (int r = 0; r < RB; ++r) g = fmaf(av[r], cv[r], g);
  for (int r = RB; r < B; ++r) g = fmaf(a[r * sa], c[r * sc], g);
  return g;
}

// sum_b a[b * sa] over the B rows, in order
template <int RB>
__device__ __forceinline__ float row_sum(const float* a, int sa, int B) {
  float av[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) av[r] = a[r * sa];
  float g = 0.0f;
#pragma unroll
  for (int r = 0; r < RB; ++r) g += av[r];
  for (int r = RB; r < B; ++r) g += a[r * sa];
  return g;
}

template <int RB>
__global__ void __launch_bounds__(kMaxThreads, 1)
fed_dense_sgd_cluster_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ y,
    const int32_t* __restrict__ idx, const float* __restrict__ w10g,
    const float* __restrict__ b10g, const float* __restrict__ w20g,
    const float* __restrict__ b20g, const int32_t* __restrict__ ns,
    const int32_t* __restrict__ n_iters, float* __restrict__ w1_out,
    float* __restrict__ b1_out, float* __restrict__ w2_out,
    float* __restrict__ b2_out, float* __restrict__ loss_out, int max_n,
    int d, int H, int C, int max_iters, int B, int R, float lr,
    float prox_mu) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int k = blockIdx.x / CS;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const bool prox = prox_mu != 0.0f;
  const bool lead = rank == 0;   // counts the replicated leaves' prox share
  const Layout L(H, C, B, R, nw, prox);
  float* w1 = smem + L.w1;
  float* w10 = smem + L.w10;
  float* xb = smem + L.xb;
  float* pub = smem + L.pub;
  float* w2 = smem + L.w2;
  float* w20 = smem + L.w20;
  float* b1 = smem + L.b1;
  float* b10 = smem + L.b10;
  float* b2 = smem + L.b2;
  float* b20 = smem + L.b20;
  float* hid = smem + L.hid;
  float* dpre = smem + L.dpre;
  float* err = smem + L.err;
  float* lrow = smem + L.lrow;
  float* rdsq = smem + L.rdsq;
  int32_t* ylab = reinterpret_cast<int32_t*>(smem + L.ylab);
  int32_t* sidx = reinterpret_cast<int32_t*>(smem + L.sidx);

  const int C2 = w2_stride(C);
  const int BP = padded_rows(B);
  const int R4 = R >> 2;
  const int r0 = rank * R;
  const int nloc = max(min(R, d - r0), 0);   // this CTA's rows of w1
  const int nq = (nloc + 3) >> 2;             // row quads (pad rows zero)
  const int qw = (R4 + nw - 1) / nw;          // quads per warp
  const int nwa = (nq + qw - 1) / qw;         // warps that hold rows
  const int q0 = warp * qw, q1 = min(q0 + qw, nq);
  const int BH = B * H;
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
  const bool hvec = (H & 3) == 0;
  // the last thread keeps the books: it publishes this CTA's FedProx share
  // and, on rank 0, the loss; its warp has the fewest rows of w1 and no
  // batch row (when nw > B), so this work stays off the longest path
  const bool acct = tid == nt - 1;

  for (int e = tid; e < R * H; e += nt) {
    const float v = e / H < nloc ? w10g[(long long)r0 * H + e] : 0.0f;
    w1[e] = v;
    if (prox) w10[e] = v;
  }
  for (int e = tid; e < H * C; e += nt) {
    const int h = e / C, c = e - h * C;
    w2[h * C2 + c] = w20g[e];
    if (prox) w20[h * C2 + c] = w20g[e];
  }
  for (int h = tid; h < H; h += nt) {
    b1[h] = b10g[h];
    b10[h] = b10g[h];
  }
  for (int c = tid; c < C; c += nt) {
    b2[c] = b20g[c];
    b20[c] = b20g[c];
  }
  for (int e = tid; e < 2 * BP * R; e += nt) xb[e] = 0.0f;
  for (int e = tid; e < BP * H; e += nt) hid[e] = dpre[e] = 0.0f;
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

    // layer 1, partial over the own rows, one warp per batch row (lane ->
    // h, h + 32 per 64, four chains over the rows mod 4), published
    // straight into this CTA's buffer for the step's parity; the last slot
    // carries the previous step's FedProx share; the warps without a
    // batch row fetch the next step's rows meanwhile
    float* pb = pub + cur * L.pub_stride;
    for (int bb = warp; bb < B; bb += nw) {
      const float4* xr = xc4 + bb * R4;
      for (int hb = 0; hb < H; hb += 64) {
        const int ha = hb + lane, hc = hb + 32 + lane;
        const float* wa = w1 + min(ha, H - 1);   // lanes past H never store
        const float* wc = w1 + min(hc, H - 1);
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
#pragma unroll 2
        for (int q = 0; q < nq; ++q) {
          const float4 xv = xr[q];
          const int o = 4 * q * H;
          a0 = fmaf(xv.x, wa[o], a0);
          a1 = fmaf(xv.y, wa[o + H], a1);
          a2 = fmaf(xv.z, wa[o + 2 * H], a2);
          a3 = fmaf(xv.w, wa[o + 3 * H], a3);
          c0 = fmaf(xv.x, wc[o], c0);
          c1 = fmaf(xv.y, wc[o + H], c1);
          c2 = fmaf(xv.z, wc[o + 2 * H], c2);
          c3 = fmaf(xv.w, wc[o + 3 * H], c3);
        }
        if (ha < H) pb[bb * H + ha] = (a0 + a1) + (a2 + a3);
        if (hc < H) pb[bb * H + hc] = (c0 + c1) + (c2 + c3);
      }
    }
    if (spare_warps_fetch && warp >= B && i + 1 < iters)
      fetch(i + 1, tid - 32 * B, nt - 32 * B);
    if (acct) pb[BH] = warps_sum(rdsq, nw);
    cluster_barrier();

    if (lead && acct && i > 0) {   // the previous step's loss
      float loss = pending;
      if (prox) {
        float s = 0.0f;
        for (int r = 0; r < CS; ++r) s += peer(pb, r)[BH];
        loss += 0.5f * prox_mu * s;
      }
      loss_sum += loss;
    }
    // one warp per batch row: h, logits, softmax, err and dpre
    for (int bb = warp; bb < B; bb += nw) {
      float* hr = hid + bb * H;
      for (int h = lane; h < H; h += 32) {   // ranks in rank order, + b1
        float v[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          if (r < CS) v[r] = peer(pb, r)[bb * H + h];
        float s = v[0];
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r)
          if (r < CS) s += v[r];
        hr[h] = tanhf(s + b1[h]);
      }
      __syncwarp();
      float* er = err + bb * C;
      float m = -INFINITY;
      for (int c = lane; c < C; c += 32) {   // logits = h w2 + b2
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        int h = 0;
        if (hvec) {   // h as float4 (H % 4 == 0: rows 16-byte aligned)
          const float4* h4 = reinterpret_cast<const float4*>(hr);
#pragma unroll 4
          for (; h + 3 < H; h += 4) {   // four chains over h mod 4
            const float4 hv = h4[h >> 2];
            a0 = fmaf(hv.x, w2[h * C2 + c], a0);
            a1 = fmaf(hv.y, w2[(h + 1) * C2 + c], a1);
            a2 = fmaf(hv.z, w2[(h + 2) * C2 + c], a2);
            a3 = fmaf(hv.w, w2[(h + 3) * C2 + c], a3);
          }
        }
        for (; h + 3 < H; h += 4) {
          a0 = fmaf(hr[h], w2[h * C2 + c], a0);
          a1 = fmaf(hr[h + 1], w2[(h + 1) * C2 + c], a1);
          a2 = fmaf(hr[h + 2], w2[(h + 2) * C2 + c], a2);
          a3 = fmaf(hr[h + 3], w2[(h + 3) * C2 + c], a3);
        }
        for (; h < H; ++h) a0 = fmaf(hr[h], w2[h * C2 + c], a0);
        const float v = ((a0 + a1) + (a2 + a3)) + b2[c];
        er[c] = v;
        m = fmaxf(m, v);
      }
      m = warp_max(m);
      float se = 0.0f;
      for (int c = lane; c < C; c += 32) se += expf(er[c] - m);
      const float lse = logf(warp_sum(se));
      const float bm = bb < nk_safe ? 1.0f : 0.0f;
      const int yb = ylab[cur * B + bb];
      float nll = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float logp = (er[c] - m) - lse;
        const float oh = c == yb ? 1.0f : 0.0f;
        nll -= logp * oh;
        er[c] = (expf(logp) - oh) * bm / bsum;
      }
      nll = warp_sum(nll);
      if (lane == 0) lrow[bb] = nll * bm;
      __syncwarp();
      for (int hb = 0; hb < H; hb += 64) {   // dpre, with the pre-step w2
        const int ha = hb + lane, hc = hb + 32 + lane;
        const float* wa = w2 + min(ha, H - 1) * C2;   // lanes past H
        const float* wc = w2 + min(hc, H - 1) * C2;   // never store
        float a0 = 0.0f, a1 = 0.0f, c0 = 0.0f, c1 = 0.0f;
        int c = 0;
        for (; c + 1 < C; c += 2) {   // two chains over c mod 2
          const float e0 = er[c], e1 = er[c + 1];
          a0 = fmaf(e0, wa[c], a0);
          a1 = fmaf(e1, wa[c + 1], a1);
          c0 = fmaf(e0, wc[c], c0);
          c1 = fmaf(e1, wc[c + 1], c1);
        }
        if (c < C) {
          a0 = fmaf(er[c], wa[c], a0);
          c0 = fmaf(er[c], wc[c], c0);
        }
        if (ha < H) {
          const float hv = hr[ha];
          dpre[bb * H + ha] = (a0 + a1) * (1.0f - hv * hv);
        }
        if (hc < H) {
          const float hv = hr[hc];
          dpre[bb * H + hc] = (c0 + c1) * (1.0f - hv * hv);
        }
      }
    }
    __syncthreads();

    // gradients and updates; the prox term reads the params before the step
    float dsq = 0.0f;
    if (warp < nwa) {   // the own rows of w1: lane -> h, warp -> row quads
      for (int hb = 0; hb < H; hb += 64) {
        const int ha = hb + lane, hc = hb + 32 + lane;
        const bool va = ha < H, vc = hc < H;
        const int hal = min(ha, H - 1), hcl = min(hc, H - 1);
        float da[RB], dc[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          da[r] = dpre[r * H + hal];
          dc[r] = dpre[r * H + hcl];
        }
        for (int q = q0; q < q1; ++q) {
          float4 xv[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) xv[r] = xc4[r * R4 + q];
          float ga[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float gc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            ga[0] = fmaf(xv[r].x, da[r], ga[0]);
            ga[1] = fmaf(xv[r].y, da[r], ga[1]);
            ga[2] = fmaf(xv[r].z, da[r], ga[2]);
            ga[3] = fmaf(xv[r].w, da[r], ga[3]);
            gc[0] = fmaf(xv[r].x, dc[r], gc[0]);
            gc[1] = fmaf(xv[r].y, dc[r], gc[1]);
            gc[2] = fmaf(xv[r].z, dc[r], gc[2]);
            gc[3] = fmaf(xv[r].w, dc[r], gc[3]);
          }
          for (int bb = RB; bb < B; ++bb) {
            const float4 xr = xc4[bb * R4 + q];
            const float ea = dpre[bb * H + hal], ec = dpre[bb * H + hcl];
            ga[0] = fmaf(xr.x, ea, ga[0]);
            ga[1] = fmaf(xr.y, ea, ga[1]);
            ga[2] = fmaf(xr.z, ea, ga[2]);
            ga[3] = fmaf(xr.w, ea, ga[3]);
            gc[0] = fmaf(xr.x, ec, gc[0]);
            gc[1] = fmaf(xr.y, ec, gc[1]);
            gc[2] = fmaf(xr.z, ec, gc[2]);
            gc[3] = fmaf(xr.w, ec, gc[3]);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int e = (4 * q + jj) * H;
            if (va)
              sgd_update(w1 + e + ha, w10 + e + ha, ga[jj], prox, true, lr,
                         prox_mu, dsq);
            if (vc)
              sgd_update(w1 + e + hc, w10 + e + hc, gc[jj], prox, true, lr,
                         prox_mu, dsq);
          }
        }
      }
    }
    for (int h = lane; warp == nw - 1 && h < H; h += 32)   // replicated b1
      sgd_update(b1 + h, b10 + h, row_sum<RB>(dpre + h, H, B), prox, lead,
                 lr, prox_mu, dsq);
    for (int e = tid; e < H * C; e += nt) {   // the replicated w2
      const int h = e / C, c = e - h * C;
      sgd_update(w2 + h * C2 + c, w20 + h * C2 + c,
                 row_dot<RB>(hid + h, H, err + c, C, B), prox, lead, lr,
                 prox_mu, dsq);
    }
    for (int c = lane; warp == nw - 1 && c < C; c += 32)   // replicated b2
      sgd_update(b2 + c, b20 + c, row_sum<RB>(err + c, C, B), prox, lead,
                 lr, prox_mu, dsq);
    if (prox) {
      dsq = warp_sum(dsq);
      if (lane == 0) rdsq[warp] = dsq;
    }
    if (lead && acct) pending = row_sum<RB>(lrow, 1, B) / bsum;
  }

  // the last step's FedProx share, then its loss
  __syncthreads();
  float* pb = pub + (iters & 1) * L.pub_stride;
  if (acct) pb[BH] = warps_sum(rdsq, nw);
  cluster_barrier();
  if (lead && acct) {
    if (iters > 0) {
      float loss = pending;
      if (prox) {
        float s = 0.0f;
        for (int r = 0; r < CS; ++r) s += peer(pb, r)[BH];
        loss += 0.5f * prox_mu * s;
      }
      loss_sum += loss;
    }
    loss_out[k] = loss_sum / fmaxf((float)iters, 1.0f);
  }
  float* w1k = w1_out + (long long)k * d * H + (long long)r0 * H;
  for (int e = tid; e < nloc * H; e += nt) w1k[e] = w1[e];
  if (lead) {
    for (int h = tid; h < H; h += nt) b1_out[(long long)k * H + h] = b1[h];
    for (int e = tid; e < H * C; e += nt) {
      const int h = e / C, c = e - h * C;
      w2_out[(long long)k * H * C + e] = w2[h * C2 + c];
    }
    for (int c = tid; c < C; c += nt) b2_out[(long long)k * C + c] = b2[c];
  }
  cluster_barrier();   // no CTA leaves while rank 0 reads its shared memory
}

typedef void (*DenseKernel)(const float*, const int32_t*, const int32_t*,
                            const float*, const float*, const float*,
                            const float*, const int32_t*, const int32_t*,
                            float*, float*, float*, float*, float*, int, int,
                            int, int, int, int, int, float, float);

static DenseKernel pick_kernel(int B) {
  switch (rows_in_registers(B)) {
    case 4: return fed_dense_sgd_cluster_kernel<4>;
    case 10: return fed_dense_sgd_cluster_kernel<10>;
    default: return fed_dense_sgd_cluster_kernel<16>;
  }
}

extern "C" long long fed_local_sgd_dense_smem_bytes(int H, int C, int B,
                                                    int R, int nw, int prox) {
  return Layout(H, C, B, R, nw, prox != 0).total * 4;
}

// How many clusters of CS CTAs (nw warps, smem bytes each) can be resident
// at once; a negative value is a CUDA error code.
extern "C" int fed_local_sgd_dense_max_clusters(int B, int CS, int nw,
                                                long long smem) {
  return max_active_clusters(pick_kernel(B), CS, nw, smem);
}

extern "C" int fed_local_sgd_dense_launch(
    const void* x, const void* y, const void* idx, const void* w10,
    const void* b10, const void* w20, const void* b20, const void* ns,
    const void* n_iters, void* w1_out, void* b1_out, void* w2_out,
    void* b2_out, void* loss_out, int K, int max_n, int d, int H, int C,
    int max_iters, int B, int CS, int R, int nw, float lr, float prox_mu,
    void* stream) {
  if (K <= 0) return 0;
  const long long smem =
      Layout(H, C, B, R, nw, prox_mu != 0.0f).total * 4;
  return launch_clusters(
      pick_kernel(B), K, CS, nw, smem, stream, (const float*)x,
      (const int32_t*)y, (const int32_t*)idx, (const float*)w10,
      (const float*)b10, (const float*)w20, (const float*)b20,
      (const int32_t*)ns, (const int32_t*)n_iters, (float*)w1_out,
      (float*)b1_out, (float*)w2_out, (float*)b2_out, (float*)loss_out,
      max_n, d, H, C, max_iters, B, R, lr, prox_mu);
}

extern "C" const char* fed_local_sgd_dense_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
