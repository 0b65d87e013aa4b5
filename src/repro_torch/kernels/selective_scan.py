"""Wrapper of the Hopper selective-scan kernel (``csrc/selective_scan.cu``),
which replaces the reference's ``repro/kernels/selective_scan.py``
``selective_scan_fwd``.

A CPU tensor goes to the plain version (``kernels.ref.selective_scan``); a
CUDA tensor launches the kernel or raises, for every sequence length
S >= 1 (prefill, and decode's S = 1 from the cached state).
``selective_scan_fwd.launches`` counts the kernel launches, and
``selective_scan_fwd.single_step_launches`` those of them at S = 1
(decode's).  The kernel runs 64 channels per block, so the grid is
(ceil(d / 64), B), and B is held to the grid's 65535.  Forward
only: the backward recomputes through the plain version
(``kernels.ops.selective_scan``), as the reference's ``_ss_bwd`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

MAX_STATE = 64


def _check_cuda(dt, A, Bmat, Cmat, x, h0):
    named = (("dt", dt), ("A", A), ("Bmat", Bmat), ("Cmat", Cmat), ("x", x),
             ("h0", h0))
    for name, t in named:
        if t.device != dt.device:
            raise ValueError(f"{name} is on {t.device}, dt on {dt.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dt.dim() != 3 or A.dim() != 2:
        raise ValueError(f"need dt [B, S, d] and A [d, N], got "
                         f"{tuple(dt.shape)} and {tuple(A.shape)}")
    B, S, d = dt.shape
    N = A.shape[1]
    if (x.shape != dt.shape or A.shape[0] != d
            or Bmat.shape != (B, S, N) or Cmat.shape != (B, S, N)
            or h0.shape != (B, d, N)):
        raise ValueError(
            f"shapes do not match: dt/x {tuple(dt.shape)}/{tuple(x.shape)}, "
            f"A {tuple(A.shape)}, B/C {tuple(Bmat.shape)}/"
            f"{tuple(Cmat.shape)}, h0 {tuple(h0.shape)}")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"state size N={N} outside [1, {MAX_STATE}]")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535")


def selective_scan_fwd(dt, A, Bmat, Cmat, x, h0):
    """dt/x: [B, S, d]; A: [d, N]; Bmat/Cmat: [B, S, N]; h0: [B, d, N], all
    float32 -> (y [B, S, d] f32, hT [B, d, N] f32)."""
    if dt.device.type == "cpu":
        return ref.selective_scan(dt, A, Bmat, Cmat, x, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    _check_cuda(dt, A, Bmat, Cmat, x, h0)
    B, S, d = dt.shape
    N = A.shape[1]
    y = torch.empty((B, S, d), dtype=torch.float32, device=dt.device)
    hT = torch.empty((B, d, N), dtype=torch.float32, device=dt.device)
    if B == 0 or d == 0:
        return y, hT
    lib = build.load("selective_scan")
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        code = lib.selective_scan_fwd_launch(
            dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            x.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B, S,
            d, N, stream)
    build.check(lib, "selective_scan_fwd", code)
    selective_scan_fwd.launches += 1
    selective_scan_fwd.single_step_launches += S == 1
    return y, hT


selective_scan_fwd.launches = 0
selective_scan_fwd.single_step_launches = 0
