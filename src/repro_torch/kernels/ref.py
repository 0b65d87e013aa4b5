"""Plain PyTorch versions of the port's kernels.

They mirror ``repro/kernels/ref.py`` op for op.  The wrappers take them for
tensors that lie on the CPU (the tests), and ``chip_smoke.py`` holds each
hand-written kernel against them on the card.
"""
from __future__ import annotations

import torch


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
