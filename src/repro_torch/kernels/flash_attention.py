"""Wrappers of the Hopper flash-attention kernels: the forward
(``csrc/flash_attention.cu``), which replaces the reference's
``repro/kernels/flash_attention.py`` ``flash_attention_fwd``, and the
backward (``csrc/flash_attention_bwd.cu``), which replaces its
``flash_attention_bwd`` (the dK/dV and dQ kernels).

A CPU tensor goes to the plain version (``kernels.ref.attention_lse``,
``kernels.ref.flash_attention_bwd``); a CUDA tensor launches the kernel
or raises.  Both sources have two routes, by dtype: bfloat16 runs on the
tensor cores (the forward on wgmma with TMA loads, the backward on
mma.sync), float32 on CUDA cores in full float32.  ``.launches`` counts
the calls that launched a kernel, ``.tensor_core_launches`` those that
took the bfloat16 route (the backward launches its delta, dK/dV and dQ
kernels per call).

On the bfloat16 route the kernels read rows with 16-byte copies, so a head
dim that is not a multiple of 8 is zero-padded here (zero columns add
nothing to q . k or to p v; the scale stays hd^-0.5 of the real head dim)
and the result sliced back, and a tensor whose storage is not 16-byte
aligned is copied first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _tc_operand(t, hd8: int):
    """``t`` as the bfloat16 route reads it: head dim padded with zeros to
    ``hd8`` (a multiple of 8) and storage 16-byte aligned."""
    if t.shape[-1] != hd8:
        return torch.nn.functional.pad(t, (0, hd8 - t.shape[-1]))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda(q, k, v, window: int, extra=()):
    for name, t in (("k", k), ("v", v)) + tuple(extra):
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
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
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
    tc = q.dtype == torch.bfloat16
    hd8 = -(-hd // 8) * 8 if tc else hd
    if tc:
        q, k, v = (_tc_operand(t, hd8) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out[..., :hd], lse
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, T, Hq, Hkv, hd8, int(bool(causal)), window,
            hd ** -0.5, _DTYPES[q.dtype], stream)
    build.check(lib, "flash_attention_fwd", code)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.tensor_core_launches += tc
    if hd8 != hd:
        out = out[..., :hd].contiguous()
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.tensor_core_launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = True,
                        window: int = 0):
    """FlashAttention-2 backward from the forward's saved ``lse``.
    q/out/do: [B, S, Hq, hd]; k/v: [B, T, Hkv, hd] (one dtype, float32 or
    bfloat16); lse: [B, Hq, S] float32 -> (dq, dk, dv) in the input shapes
    and dtype.  ``delta = rowsum(dO * O)``, which the reference takes
    outside its kernels, is a plain torch op here on the float32 route and
    a kernel of the same C entry on the bfloat16 route."""
    window = int(window)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                       window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k, v, window, (("do", do),))
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must be shaped like q {tuple(q.shape)}")
    if (lse.shape != (B, Hq, S) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [B, Hq, S] = "
                         f"{(B, Hq, S)} on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    if out.device != q.device:
        raise ValueError(f"out is on {out.device}, q on {q.device}")
    if out.dtype != q.dtype:
        raise TypeError(f"out is {out.dtype}, q is {q.dtype}")
    tc = q.dtype == torch.bfloat16
    hd8 = -(-hd // 8) * 8 if tc else hd
    if tc:
        q, k, v, out, do = (_tc_operand(t, hd8)
                            for t in (q, k, v, out.contiguous(), do))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0:
        return dq[..., :hd], dk.zero_()[..., :hd], dv.zero_()[..., :hd]
    if tc:      # scratch for the C entry's delta kernel
        delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    else:
        delta = torch.einsum("bshd,bshd->bhs", do, out).contiguous()
    lib = build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, T, Hq, Hkv, hd8,
            int(bool(causal)), window, hd ** -0.5, _DTYPES[q.dtype], stream)
    build.check(lib, "flash_attention_bwd", code)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.tensor_core_launches += tc
    if hd8 != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.tensor_core_launches = 0
