"""Wrapper of the Hopper flash-attention forward kernel
(``csrc/flash_attention.cu``), which replaces the reference's
``repro/kernels/flash_attention.py`` ``flash_attention_fwd``.

A CPU tensor goes to the plain version (``kernels.ref.attention_lse``); a
CUDA tensor launches the kernel or raises.  ``flash_attention_fwd.launches``
counts the kernel launches.  Forward only: serving differentiates nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _check_cuda(q, k, v, window: int):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, S, Hq, hd] and k/v [B, T, Hkv, hd], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside [1, {MAX_HEAD_DIM}]")
    if window < 0:
        raise ValueError(f"window={window} must be >= 0")
    if Hq > 65535 or B > 65535:
        raise ValueError(f"the grid takes at most 65535 heads and batch "
                         f"rows, got Hq={Hq}, B={B}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0):
    """q: [B, S, Hq, hd]; k/v: [B, T, Hkv, hd] (float32 or bfloat16, one
    dtype) -> (out [B, S, Hq, hd] in q's dtype, lse [B, Hq, S] float32).
    Causal masks k > q; ``window`` > 0 also masks k <= q - window."""
    window = int(window)
    if q.device.type == "cpu":
        return ref.attention_lse(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k, v, window)
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, T, Hq, Hkv, hd, int(bool(causal)), window,
            hd ** -0.5, _DTYPES[q.dtype], stream)
    build.check(lib, "flash_attention_fwd", code)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
