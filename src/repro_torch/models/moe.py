"""Mixture-of-Experts FFN, the port's copy of ``repro/models/moe.py``.

Top-k routing over ``n_experts`` experts with a per-(row, expert)
capacity ``C = ceil(S * k / E * capacity_factor)``; assignments past it
are dropped.  The reference splits the experts over its mesh's model
axis (M shards); the port runs on one card, so M = 1 always and the
experts are one [E, ...] stack.  The order of operations is the
reference's: the RMS-normed input feeds only the router (float32 logits,
softmax, top-k, gates renormalised), while the experts receive the
un-normalised ``x`` cast to the compute dtype; the three expert products
run in the compute dtype with SiLU gating, and the combine weighs the
gathered expert outputs by the gates in float32.

Everything is plain torch with no host read, so a captured round (the
scan driver's CUDA graph) can hold it: the counts are a ``scatter_add_``
of ones, the top-k a stable descending sort (ties to the lowest index,
as ``lax.top_k``).  Every kept buffer slot receives exactly one token
(dispatch writes with ``scatter``, not an atomic add), and only the
discarded overflow slot receives many, so no kept value depends on the
order of atomics, forward or backward.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense_init, rms_norm, silu


def init_moe(generator, cfg, d_ff=None, device=None, stack: int = 0):
    """The reference's tree: router [d, E] float32, w_gate / w_up [E, d, f]
    and w_down [E, f, d] (scale f^-0.5) in ``params_dtype``, norm [d];
    ``stack`` > 0 prepends a group axis.  ``dense_init``'s default scale
    is shape[0]^-0.5, E^-0.5 for the expert stacks, as in the
    reference."""
    d, f, E = cfg.d_model, d_ff or cfg.d_ff, cfg.n_experts
    dt = cfg.params_dtype
    mk = lambda shape, dtype, scale=None: dense_init(generator, shape, dtype,
                                                     scale, device, stack)
    return {
        "router": mk((d, E), torch.float32),
        "w_gate": mk((E, d, f), dt),
        "w_up": mk((E, d, f), dt),
        "w_down": mk((E, f, d), dt, f ** -0.5),
        "norm": torch.ones(((stack,) if stack else ()) + (d,), dtype=dt,
                           device=device),
    }


def moe_capacity(cfg, seq_len: int) -> int:
    """Slots per (row, expert) for a call of ``seq_len`` positions (decode
    runs at S = 1)."""
    per_expert = seq_len * cfg.experts_per_token / cfg.n_experts
    return max(1, int(math.ceil(per_expert * cfg.capacity_factor)))


def _bmm(a, b):
    """[E, T, i] @ [E, i, o] in the operands' dtype.  A bfloat16 product
    is taken in float32 and rounded once on the CPU, as ``layers.linear``
    does (XLA and cuBLAS accumulate in float32 and round once)."""
    if a.dtype == torch.bfloat16 and a.device.type == "cpu":
        return torch.bmm(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)
    return torch.bmm(a, b)


def route(params, cfg, x):
    """The router: (gates [B, S, k] float32, eidx [B, S, k] int64, aux
    0-d float32), aux the Switch load-balance loss ``E * sum(mean(probs)
    * mean(one_hot(top-1)))``."""
    E, k = cfg.n_experts, cfg.experts_per_token
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = h.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eidx = vals[..., :k], order[..., :k]
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                    min=1e-9)
    me = probs.mean(dim=(0, 1))
    top1 = (eidx[..., :1] == torch.arange(E, device=x.device)).to(
        torch.float32)
    aux = E * torch.sum(me * top1.mean(dim=(0, 1)))
    return gates, eidx, aux


def assign(eidx, E: int, C: int):
    """Slot bookkeeping of the [B, S, k] expert ids, token-major (token t's
    j-th choice at t * k + j): (dest [B, S*k] int64, the buffer slot
    ``e * C + pos`` of a kept assignment and the overflow slot ``E * C``
    of a dropped one; keep [B, S*k] bool, pos < C), where pos is the
    assignment's rank among its row's assignments to the same expert in
    token order (a stable sort)."""
    B = eidx.shape[0]
    eflat = eidx.reshape(B, -1)
    Sk = eflat.shape[1]
    order = torch.argsort(eflat, dim=-1, stable=True)
    sorted_e = torch.gather(eflat, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64,
                         device=eidx.device).scatter_add_(
        1, eflat, torch.ones_like(eflat))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_sorted = (torch.arange(Sk, device=eidx.device)[None, :]
                  - torch.gather(starts, 1, sorted_e))
    keep_sorted = pos_sorted < C
    slot_sorted = torch.where(keep_sorted,
                              sorted_e * C + torch.clamp(pos_sorted,
                                                         max=C - 1),
                              E * C)
    dest = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    return dest, keep


def moe_forward(params, cfg, x):
    """x: [B, S, d] -> (out [B, S, d] in x's dtype, aux 0-d float32)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = moe_capacity(cfg, S)
    cdt = cfg.compute_dtype
    gates, eidx, aux = route(params, cfg, x)
    dest, _ = assign(eidx, E, C)                         # [B, S*k]

    # dispatch: token t's copy j to its slot; a kept slot gets one token
    xc = x.to(cdt)
    xr = xc[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    idx = dest[..., None].expand(B, S * k, d)
    buf = torch.zeros((B, E * C + 1, d), dtype=cdt, device=x.device)
    buf = buf.scatter(1, idx, xr)
    ebuf = buf[:, :E * C].reshape(B, E, C, d)

    # the experts: [E, B*C, d] against [E, d, f] in the compute dtype
    xe = ebuf.permute(1, 0, 2, 3).reshape(E, B * C, d)
    wg, wu, wd = (params[n].to(cdt) for n in ("w_gate", "w_up", "w_down"))
    o = _bmm(silu(_bmm(xe, wg)) * _bmm(xe, wu), wd)      # [E, B*C, d]
    o = o.reshape(E, B, C, d).permute(1, 0, 2, 3).reshape(B, E * C, d)
    o = torch.cat([o, torch.zeros((B, 1, d), dtype=o.dtype,
                                  device=o.device)], dim=1)

    # combine: every assignment's output (the overflow row is 0), weighed
    # by its gate in float32 and summed over the k choices
    gall = torch.gather(o, 1, idx)                       # [B, S*k, d]
    acc = (gall.reshape(B, S, k, d).to(torch.float32)
           * gates[..., None]).sum(2)
    return acc.to(x.dtype), aux
