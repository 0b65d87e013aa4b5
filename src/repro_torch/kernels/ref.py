"""Plain PyTorch versions of the port's kernels.

They mirror ``repro/kernels/ref.py`` op for op.  The wrappers take them for
tensors that lie on the CPU (the tests), and ``chip_smoke.py`` holds each
hand-written kernel against them on the card.
"""
from __future__ import annotations

import torch

#: the masked score of the reference's attention (a finite -1e30, not -inf)
NEG_INF = -1e30


def _attention_mask(S: int, T: int, *, causal: bool, window: int, device):
    """[S, T] bool: True where key t is visible to query s."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def _attention_scores(q, k, *, causal: bool, window: int):
    """Masked scaled scores [B, Hkv, G, S, T] in float32 (GQA: q head h
    reads kv head h // G)."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd).to(torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32)) \
        * hd ** -0.5
    mask = _attention_mask(S, T, causal=causal, window=window,
                           device=q.device)
    return torch.where(mask, s, torch.full((), NEG_INF, device=q.device))


def attention_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive full-softmax attention with GQA, op for op the reference's
    ``ref.attention``, plus the per-row log-sum-exp of the masked scores:
    the two outputs of the flash-attention forward kernel (its backward
    pass recomputes the probabilities from lse).

    q: [B, S, Hq, hd]; k/v: [B, T, Hkv, hd] -> (out [B, S, Hq, hd] in q's
    dtype, lse [B, Hq, S] f32)."""
    B, S, Hq, hd = q.shape
    s = _attention_scores(q, k, causal=causal, window=window)
    lse = torch.logsumexp(s, dim=-1).reshape(B, Hq, S)
    o = torch.einsum("bkgqt,btkd->bqkgd", torch.softmax(s, dim=-1),
                     v.to(torch.float32))
    return o.reshape(B, S, Hq, hd).to(q.dtype), lse


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """The output of ``attention_lse`` alone (the reference oracle's
    signature)."""
    return attention_lse(q, k, v, causal=causal, window=window)[0]


def attention_lse_tc(q, k, v, *, causal: bool = True, window: int = 0):
    """Rounding model of the flash forward's bfloat16 tensor-core route:
    ``attention_lse`` with the probabilities rounded to bfloat16 before the
    product with v, where that kernel rounds P to feed it to the tensor
    cores; the row sum l stays the float32 sum of the unrounded P, as in
    the kernel.  (The kernel rounds P against its running row max and
    rescales in float32; the model rounds against the final max.)  Nothing
    on the main path calls it: the tests hold the kernel to it at a bound
    much tighter than the reference's 2e-2.

    q: [B, S, Hq, hd]; k/v: [B, T, Hkv, hd] -> (out [B, S, Hq, hd] in q's
    dtype, lse [B, Hq, S] f32)."""
    B, S, Hq, hd = q.shape
    s = _attention_scores(q, k, causal=causal, window=window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgqt,btkd->bqkgd", _round_bf16(p),
                     v.to(torch.float32))
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(B, Hq, S)
    return o.reshape(B, S, Hq, hd).to(q.dtype), lse


def _round_bf16(x):
    """x rounded to bfloat16 and widened back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _flash_bwd(q, k, v, out, lse, do, causal, window, rnd):
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = hd ** -0.5
    f32 = torch.float32
    qf = q.to(f32).reshape(B, S, Hkv, G, hd)
    dof = do.to(f32).reshape(B, S, Hkv, G, hd)
    kf, vf = k.to(f32), v.to(f32)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kf) * scale
    mask = _attention_mask(S, T, causal=causal, window=window,
                           device=q.device)
    lse_g = lse.to(f32).reshape(B, Hkv, G, S, 1)
    p = torch.where(mask, torch.exp(s - lse_g),
                    torch.zeros((), dtype=f32, device=q.device))
    delta = torch.einsum("bshd,bshd->bhs", do.to(f32), out.to(f32))
    delta = delta.reshape(B, Hkv, G, S, 1)
    dv = torch.einsum("bkgqt,bqkgd->btkd", rnd(p), dof)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dof, vf)
    ds = rnd(p * (dp - delta) * scale)
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qf)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, kf).reshape(B, S, Hq, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int = 0):
    """Plain FlashAttention-2 backward from the forward's saved lse: what
    the reference's ``_bwd_kv_kernel`` and ``_bwd_q_kernel`` compute, with
    GQA summed over each kv head's group of q heads.

      p  = exp(s - lse) on unmasked pairs, 0 elsewhere
      dv = p^T dO,   dp = dO v^T,   ds = p (dp - delta) * scale
      dk = ds^T q,   dq = ds k,     delta = rowsum(dO * O)

    q/out/do: [B, S, Hq, hd]; k/v: [B, T, Hkv, hd]; lse: [B, Hq, S] f32 ->
    (dq, dk, dv) in the input dtypes, float32 inside."""
    return _flash_bwd(q, k, v, out, lse, do, causal, window, lambda x: x)


def flash_attention_bwd_tc(q, k, v, out, lse, do, *, causal: bool = True,
                           window: int = 0):
    """Rounding model of the flash backward's bfloat16 tensor-core route:
    ``flash_attention_bwd`` with p rounded to bfloat16 for dv = p^T dO and
    ds rounded to bfloat16 for dk = ds^T q and dq = ds k, where those
    kernels round them to feed the tensor cores; ds itself is taken from
    the unrounded float32 p, as in the kernels.  Nothing on the main path
    calls it."""
    return _flash_bwd(q, k, v, out, lse, do, causal, window, _round_bf16)


def softmax_xent_lse(h, W, labels):
    """Row-wise cross-entropy of the logits ``h @ W`` and each row's
    log-sum-exp, what the port's forward kernels return: (loss [T], lse
    [T]) float32.  The loss is op for op the reference's
    ``ref.softmax_xent``: both operands upcast to float32 before the
    product.  h: [T, d]; W: [d, V]; labels: [T] int."""
    logits = h.to(torch.float32) @ W.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return lse - gold, lse


def softmax_xent(h, W, labels):
    """The reference's ``ref.softmax_xent``: the loss [T] f32 of
    ``softmax_xent_lse``."""
    return softmax_xent_lse(h, W, labels)[0]


def softmax_xent_dlogits(h, W, labels, lse, g):
    """The gradient of ``sum(g * softmax_xent(h, W, labels))`` with respect
    to the float32 logits ``h @ W``, from the forward's saved lse:
    ``(exp(logits - lse) - onehot(labels)) * g``, [T, V] float32.  A label
    outside [0, V) matches no column."""
    logits = h.to(torch.float32) @ W.to(torch.float32)
    cols = torch.arange(logits.shape[1], device=logits.device)
    onehot = (cols[None, :] == labels.long()[:, None]).to(torch.float32)
    return (torch.exp(logits - lse[:, None]) - onehot) * g[:, None]


def split_bf16(x):
    """(hi, lo) in bfloat16 with hi = bf16(x) and lo = bf16(x - hi), so
    that hi + lo carries float32 x to ~2^-17 of its value."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def softmax_xent_bwd(h, W, labels, lse, g):
    """Plain backward of ``softmax_xent`` from the saved lse, the vjp that
    the reference's ``_fx_bwd`` takes: dlogits in float32, then
    ``dh = dlogits W^T`` and ``dW = h^T dlogits`` as explicit float32
    products, returned in h's and W's dtypes."""
    dl = softmax_xent_dlogits(h, W, labels, lse, g)
    dh = dl @ W.to(torch.float32).T
    dW = h.to(torch.float32).T @ dl
    return dh.to(h.dtype), dW.to(W.dtype)


def softmax_xent_bwd_tc(h, W, labels, lse, g):
    """Rounding model of the backward kernels' bfloat16 tensor-core route
    (``csrc/fused_xent_bwd.cu``): dlogits split into bf16 hi and lo, each
    half's product taken in float32 (bf16 x bf16 products are exact there)
    and both summed before one rounding to h's and W's dtypes.  Nothing on
    the main path calls it."""
    hi, lo = split_bf16(softmax_xent_dlogits(h, W, labels, lse, g))
    hi, lo = hi.to(torch.float32), lo.to(torch.float32)
    Wf, hf = W.to(torch.float32), h.to(torch.float32)
    dh = hi @ Wf.T + lo @ Wf.T
    dW = hf.T @ hi + hf.T @ lo
    return dh.to(h.dtype), dW.to(W.dtype)


def selective_scan(dt, A, Bmat, Cmat, x, h0):
    """Step-by-step Mamba-1 recurrence, op for op the reference's
    ``ref.selective_scan``:

      h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = h_t . C_t

    dt/x: [B, S, d]; A: [d, N]; Bmat/Cmat: [B, S, N]; h0: [B, d, N] ->
    (y [B, S, d] f32, hT [B, d, N] f32)."""
    dt = dt.to(torch.float32)
    x = x.to(torch.float32)
    A = A.to(torch.float32)
    Bmat = Bmat.to(torch.float32)
    Cmat = Cmat.to(torch.float32)
    h = h0.to(torch.float32)
    ys = []
    for t in range(dt.shape[1]):
        dt_t, x_t = dt[:, t], x[:, t]                          # [B, d]
        dA = torch.exp(dt_t[..., None] * A)                    # [B, d, N]
        h = dA * h + (dt_t * x_t)[..., None] * Bmat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cmat[:, t]))
    if ys:
        y = torch.stack(ys, dim=1)
    else:
        y = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
    return y, h


def fed_cohort_gather(flat_x, flat_y, starts, ns, *, max_n: int):
    """Windowed cohort gather: for each client k, rows
    [starts[k], starts[k]+max_n) of the flat federation, plus the validity
    mask ``pos < ns[k]``.  Starts are clamped to ``rows - max_n``; padding
    rows hold the window tail and are cancelled by the mask."""
    starts = torch.clamp(starts.long(), max=flat_x.shape[0] - max_n)
    pos = torch.arange(max_n, device=flat_x.device)
    idx = starts[:, None] + pos[None, :]
    mask = (pos[None, :] < ns.long()[:, None]).to(torch.float32)
    return flat_x[idx], flat_y[idx], mask


def fed_local_sgd_mclr(x, y, idx, w0, b0, ns, n_iters, *, lr: float,
                       prox_mu: float = 0.0):
    """Masked budgeted MCLR local SGD over precomputed iid minibatch
    indices.  x: [K, max_n, d] f32; y: [K, max_n] i32; idx: [K, max_iters,
    B] i32; w0: [d, C]; b0: [C]; ns/n_iters: [K] i32 -> (w_k [K, d, C],
    b_k [K, C], losses [K] f32).

    Every client runs all ``max_iters`` slots with updates masked past
    ``n_iters_k``, exactly as the reference's scan; the clients are a
    batch dimension in place of ``vmap``."""
    K, max_n, d = x.shape
    max_iters, B = idx.shape[1], idx.shape[2]
    C = w0.shape[1]
    dev = x.device
    nk_safe = torch.clamp(ns.long(), min=1)
    bmask = (torch.arange(B, device=dev)[None, :]
             < nk_safe[:, None]).to(torch.float32)                 # [K, B]
    bsum = torch.clamp(bmask.sum(1), min=1.0)                      # [K]
    # the reference's jnp gather clamps out-of-range indices
    idx = torch.clamp(idx.long(), 0, max_n - 1)
    oy = torch.nn.functional.one_hot(y.long(), C).to(torch.float32)
    w = w0.to(torch.float32).expand(K, d, C)
    b = b0.to(torch.float32).expand(K, C)
    w0f, b0f = w, b
    iters = n_iters.long()
    losses = []
    for i in range(max_iters):
        idx_row = idx[:, i, :]                                     # [K, B]
        xb = torch.gather(x.to(torch.float32), 1,
                          idx_row[:, :, None].expand(K, B, d))
        oyb = torch.gather(oy, 1, idx_row[:, :, None].expand(K, B, C))
        logits = torch.bmm(xb, w) + b[:, None, :]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.sum(logp * oyb, dim=-1)                       # [K, B]
        loss = torch.sum(nll * bmask, dim=1) / bsum
        err = (torch.exp(logp) - oyb) * bmask[:, :, None] / bsum[:, None,
                                                                 None]
        gw = torch.bmm(xb.transpose(1, 2), err)
        gb = err.sum(1)
        if prox_mu:
            loss = loss + 0.5 * prox_mu * (
                torch.sum((w - w0f) ** 2, dim=(1, 2))
                + torch.sum((b - b0f) ** 2, dim=1))
            gw = gw + prox_mu * (w - w0f)
            gb = gb + prox_mu * (b - b0f)
        active = (i < iters).to(torch.float32)
        w = w - lr * active[:, None, None] * gw
        b = b - lr * active[:, None] * gb
        losses.append(loss)
    msk = (torch.arange(max_iters, device=dev)[None, :]
           < iters[:, None]).to(torch.float32)
    if max_iters:
        total = (torch.stack(losses, 1) * msk).sum(1)
    else:
        total = torch.zeros(K, device=dev)
    return (w.contiguous(), b.contiguous(),
            total / torch.clamp(msk.sum(1), min=1.0))


def fed_compress_topk_q8(ef, *, k: int):
    """Top-k + int8 upload compression over per-client delta rows, bitwise
    the reference's ``ref.fed_compress_topk_q8``.

    ef: [K, P] f32 error-feedback deltas; ``k`` kept-coordinate count ->
    (q [K, P] int8, zero off the per-row top-k mask; scale [K] f32, the
    per-client symmetric scale).  Transmitted value = q * scale.

      scale = max|e| * float32(1/127)     (a multiply, as the reference)
      thr   = sort(|e|)[P - k]            (k-th largest magnitude)
      mask  = (|e| > thr) | the earliest (|e| == thr) ties, exactly k
      q     = clip(round_half_even(e / scale), -127, 127) on the mask"""
    K, P = ef.shape
    e = ef.to(torch.float32)
    a = torch.abs(e)
    amax = (torch.amax(a, dim=-1) if P
            else torch.zeros(K, dtype=torch.float32, device=e.device))
    scale = amax * torch.tensor(1.0 / 127.0, dtype=torch.float32,
                                device=e.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    if k <= 0:
        mask = torch.zeros(e.shape, dtype=torch.bool, device=e.device)
    elif k >= P:
        mask = torch.ones(e.shape, dtype=torch.bool, device=e.device)
    else:
        thr = torch.sort(a, dim=-1).values[:, P - k]
        gt = a > thr[:, None]
        eq = a == thr[:, None]
        # exactly k coordinates: all strictly above plus the EARLIEST ties
        need = k - torch.sum(gt.to(torch.int32), dim=-1)
        take = eq & (torch.cumsum(eq.to(torch.int32), dim=-1)
                     <= need[:, None])
        mask = gt | take
    q = torch.where(mask & (scale[:, None] > 0),
                    torch.clamp(torch.round(e / safe[:, None]), -127.0,
                                127.0),
                    torch.zeros((), device=e.device)).to(torch.int8)
    return q, scale


def fed_local_sgd_dense(x, y, idx, w10, b10, w20, b20, ns, n_iters, *,
                        lr: float, prox_mu: float = 0.0):
    """Masked budgeted two-layer (tanh MLP) local SGD over precomputed iid
    minibatch indices.  x: [K, max_n, d] f32; y: [K, max_n] i32; idx:
    [K, max_iters, B] i32; w10: [d, H]; b10: [H]; w20: [H, C]; b20: [C];
    ns/n_iters: [K] i32 -> (w1_k [K, d, H], b1_k [K, H], w2_k [K, H, C],
    b2_k [K, C], losses [K] f32).

    The backward pass is the closed-form two-layer backprop of the
    reference's oracle; every client runs all ``max_iters`` slots with
    updates masked past ``n_iters_k``, the clients a batch dimension in
    place of ``vmap``."""
    K, max_n, d = x.shape
    max_iters, B = idx.shape[1], idx.shape[2]
    H, C = w20.shape
    dev = x.device
    nk_safe = torch.clamp(ns.long(), min=1)
    bmask = (torch.arange(B, device=dev)[None, :]
             < nk_safe[:, None]).to(torch.float32)                 # [K, B]
    bsum = torch.clamp(bmask.sum(1), min=1.0)                      # [K]
    idx = torch.clamp(idx.long(), 0, max_n - 1)
    oy = torch.nn.functional.one_hot(y.long(), C).to(torch.float32)
    init = [t.to(torch.float32) for t in (w10, b10, w20, b20)]
    w1, b1, w2, b2 = (t.expand((K,) + tuple(t.shape)) for t in init)
    w10f, b10f, w20f, b20f = w1, b1, w2, b2
    iters = n_iters.long()
    losses = []
    for i in range(max_iters):
        idx_row = idx[:, i, :]                                     # [K, B]
        xb = torch.gather(x.to(torch.float32), 1,
                          idx_row[:, :, None].expand(K, B, d))
        oyb = torch.gather(oy, 1, idx_row[:, :, None].expand(K, B, C))
        h = torch.tanh(torch.bmm(xb, w1) + b1[:, None, :])          # [K,B,H]
        logits = torch.bmm(h, w2) + b2[:, None, :]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.sum(logp * oyb, dim=-1)
        loss = torch.sum(nll * bmask, dim=1) / bsum
        err = (torch.exp(logp) - oyb) * bmask[:, :, None] / bsum[:, None,
                                                                 None]
        gw2 = torch.bmm(h.transpose(1, 2), err)
        gb2 = err.sum(1)
        dpre = torch.bmm(err, w2.transpose(1, 2)) * (1.0 - h * h)
        gw1 = torch.bmm(xb.transpose(1, 2), dpre)
        gb1 = dpre.sum(1)
        if prox_mu:
            loss = loss + 0.5 * prox_mu * (
                torch.sum((w1 - w10f) ** 2, dim=(1, 2))
                + torch.sum((b1 - b10f) ** 2, dim=1)
                + torch.sum((w2 - w20f) ** 2, dim=(1, 2))
                + torch.sum((b2 - b20f) ** 2, dim=1))
            gw1 = gw1 + prox_mu * (w1 - w10f)
            gb1 = gb1 + prox_mu * (b1 - b10f)
            gw2 = gw2 + prox_mu * (w2 - w20f)
            gb2 = gb2 + prox_mu * (b2 - b20f)
        active = (i < iters).to(torch.float32)
        w1 = w1 - lr * active[:, None, None] * gw1
        b1 = b1 - lr * active[:, None] * gb1
        w2 = w2 - lr * active[:, None, None] * gw2
        b2 = b2 - lr * active[:, None] * gb2
        losses.append(loss)
    msk = (torch.arange(max_iters, device=dev)[None, :]
           < iters[:, None]).to(torch.float32)
    if max_iters:
        total = (torch.stack(losses, 1) * msk).sum(1)
    else:
        total = torch.zeros(K, device=dev)
    return (w1.contiguous(), b1.contiguous(), w2.contiguous(),
            b2.contiguous(), total / torch.clamp(msk.sum(1), min=1.0))
