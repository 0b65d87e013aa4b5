"""Mamba-1 selective-state-space mixer (Falcon-Mamba), the port's copy of
``repro/models/mamba.py`` for training and serving.

The recurrence goes through the selective-scan op for every sequence
length: the hand-written kernel on a CUDA tensor (training and prefill,
and decode's single step from the cached state), the plain step loop on a
CPU tensor.  The op is differentiable: its backward is the scan's
backward kernel on a CUDA tensor and its plain reverse recurrence on a CPU
tensor, both linear in S, as the reference's ``jax.vjp`` of its oracle
is.
The reference's chunked associative scan is a TPU formulation of the same
function and is not copied.  Decode keeps a constant [B, d_inner, N] state
plus a [B, K-1, d_inner] conv ring.

Both of the reference's scan options are accepted and computed as its
kernel route computes them: ``ssm_scan="sequential"`` is the recurrence
this module already runs, and ``ssm_input_dtype`` feeds only the
reference's chunked route (its kernel and sequential routes ignore it),
so the scan's inputs stay float32 under "bfloat16" too (ROADMAP §C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, linear, rms_norm, silu


#: logical axes of a Mamba mixer's leaves (the reference's)
MAMBA_SPECS = {
    "in_proj": ("fsdp", "ssm_inner"),
    "conv_w": ("none", "ssm_inner"),
    "conv_b": ("ssm_inner",),
    "x_proj": ("ssm_inner", "none"),
    "dt_proj": ("none", "ssm_inner"),
    "dt_bias": ("ssm_inner",),
    "A_log": ("ssm_inner", "ssm_state"),
    "D": ("ssm_inner",),
    "out_proj": ("ssm_inner", "fsdp"),
    "norm": ("embed",),
}


def init_mamba(generator, cfg, device=None, stack: int = 0):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, K = cfg.resolved_dt_rank, cfg.ssm_conv
    dt = cfg.params_dtype
    lead = (stack,) if stack else ()
    mk = lambda shape, scale=None: dense_init(generator, shape, dt, scale,
                                              device, stack)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": mk((d, 2 * di)),
        "conv_w": mk((K, di), K ** -0.5),
        "conv_b": torch.zeros(lead + (di,), dtype=dt, device=device),
        "x_proj": mk((di, dtr + 2 * N)),
        "dt_proj": mk((dtr, di), dtr ** -0.5),
        "dt_bias": torch.zeros(lead + (di,), dtype=dt, device=device),
        "A_log": a_log.expand(lead + (di, N)).contiguous(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=device),
        "out_proj": mk((di, d), di ** -0.5),
        "norm": torch.ones(lead + (d,), dtype=dt, device=device),
    }


def softplus(x):
    """``max(x, 0) + log1p(exp(-|x|))`` as separate ops: the reference's
    ``jax.nn.softplus`` (``logaddexp(x, 0)``), rounded at each step in
    bfloat16 as it is there."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssm_pieces(params, cfg, xz):
    """xz: [B, S, di] post-conv activations -> (dt, A, B, C) raw pieces,
    float32."""
    N, dtr = cfg.ssm_state, cfg.resolved_dt_rank
    proj = linear(xz, params["x_proj"])                   # [B, S, dtr+2N]
    dt_lr, Bmat, Cmat = torch.split(proj, [dtr, N, N], dim=-1)
    pre = linear(dt_lr, params["dt_proj"]) + params["dt_bias"].to(xz.dtype)
    dt = softplus(pre).to(torch.float32)
    A = -torch.exp(params["A_log"])                       # [di, N]
    return dt, A, Bmat.to(torch.float32), Cmat.to(torch.float32)


def selective_scan(params, cfg, xz, h0=None):
    """xz: [B, S, di] -> (y [B, S, di] in xz's dtype, h_final [B, di, N]
    f32)."""
    B, S, di = xz.shape
    if h0 is None:
        h0 = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                         device=xz.device)
    dt, A, Bmat, Cmat = _ssm_pieces(params, cfg, xz)
    xf = xz.to(torch.float32).contiguous()
    y, hT = kops.selective_scan(dt.contiguous(), A.contiguous(),
                                Bmat.contiguous(), Cmat.contiguous(), xf,
                                h0.contiguous())
    y = y + params["D"] * xf
    return y.to(xz.dtype), hT


def _causal_conv(params, cfg, x, conv_state=None):
    """Depthwise causal conv1d.  x: [B, S, di]."""
    K = cfg.ssm_conv
    w = params["conv_w"].to(x.dtype)                      # [K, di]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_state = xp[:, xp.shape[1] - (K - 1):] if K > 1 else xp[:, :0]
    return out + params["conv_b"].to(x.dtype), new_state


def mamba_forward(params, cfg, x, positions=None, *, cache=None):
    """Full-sequence mixer (or one decode step, from ``cache``).  Returns
    (out, new_cache)."""
    del positions
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    xz = linear(h, params["in_proj"])                     # [B, S, 2di]
    xpart, z = torch.chunk(xz, 2, dim=-1)
    conv_state = None if cache is None else cache["conv"]
    xc, new_conv = _causal_conv(params, cfg, xpart, conv_state)
    xc = silu(xc)
    h0 = None if cache is None else cache["ssm"]
    y, hT = selective_scan(params, cfg, xc, h0)
    out = linear(y * silu(z), params["out_proj"])
    return out, {"conv": new_conv.to(cfg.compute_dtype), "ssm": hT}


def mamba_decode(params, cfg, x, cache, cur_index):
    """Single-token decode with constant state.  x: [B, 1, d]."""
    del cur_index
    return mamba_forward(params, cfg, x, cache=cache)


def mamba_cache_init(cfg, batch: int, max_len: int = 0, device=None):
    del max_len
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((batch, K - 1, di), dtype=cfg.compute_dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, N), dtype=torch.float32,
                               device=device)}
