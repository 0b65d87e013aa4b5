"""Wrappers of the Hopper selective-scan kernels: the forward
(``csrc/selective_scan.cu``), which replaces the reference's
``repro/kernels/selective_scan.py`` ``selective_scan_fwd``, and the
backward (``csrc/selective_scan_bwd.cu``), the port's counterpart of the
reference's ``_ss_bwd`` (``jax.vjp`` of its oracle, no TPU kernel).

A CPU tensor goes to the plain version (``kernels.ref.selective_scan``,
``ref.selective_scan_bwd``); a CUDA tensor launches the kernel or raises,
for every sequence length S >= 1 (prefill, and decode's S = 1 from the
cached state).  ``selective_scan_fwd.launches`` counts the forward's
launches, and ``selective_scan_fwd.single_step_launches`` those of them
at S = 1 (decode's); ``selective_scan_bwd.launches`` counts the
backward's, and ``selective_scan_bwd.own_checkpoint_launches`` the
checkpointing forwards it launches itself when it is given no
checkpoints (none on the training path).  The training forward asks for
the checkpoints of h at every ``checkpoint_steps(N)``-th step
(``checkpoints=True``), which the backward takes.  Both kernels run one
block per (64 channels, batch row); the grid's y axis is the batch, held
to 65535.
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


def checkpoint_steps(N: int) -> int:
    """Steps between the chunk checkpoints of h (``ref.scan_checkpoint_steps``:
    16 up to N = 16, 8 up to 32, 4 up to 64)."""
    return ref.scan_checkpoint_steps(N)


def _forward(dt, A, Bmat, Cmat, x, h0, checkpoints):
    """Launch the forward kernel (its checkpointing instance when
    ``checkpoints``) on CUDA tensors, uncounted -> (y, hT[, ckpt])."""
    _check_cuda(dt, A, Bmat, Cmat, x, h0)
    B, S, d = dt.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32, device=dt.device)
    y = torch.empty((B, S, d), **f32)
    hT = torch.empty((B, d, N), **f32)
    ckpt = (torch.empty((B, -(-S // checkpoint_steps(N)), d, N), **f32)
            if checkpoints else None)
    out = (y, hT) if ckpt is None else (y, hT, ckpt)
    if B == 0 or d == 0:
        return out
    lib = build.load("selective_scan")
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        code = lib.selective_scan_fwd_launch(
            dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            x.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
            None if ckpt is None else ckpt.data_ptr(), B, S, d, N, stream)
    build.check(lib, "selective_scan_fwd", code)
    return out


def selective_scan_fwd(dt, A, Bmat, Cmat, x, h0, checkpoints: bool = False):
    """dt/x: [B, S, d]; A: [d, N]; Bmat/Cmat: [B, S, N]; h0: [B, d, N], all
    float32 -> (y [B, S, d] f32, hT [B, d, N] f32), and with
    ``checkpoints`` also h at the start of every chunk of
    ``checkpoint_steps(N)`` steps, [B, ceil(S / CK), d, N] f32, which the
    backward takes in place of recomputing them (the kernel's
    checkpointing instance: the same arithmetic, y and hT bitwise)."""
    if dt.device.type == "cpu":
        return ref.selective_scan(dt, A, Bmat, Cmat, x, h0,
                                  checkpoints=checkpoints)
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    out = _forward(dt, A, Bmat, Cmat, x, h0, checkpoints)
    S = dt.shape[1]
    selective_scan_fwd.launches += 1
    selective_scan_fwd.single_step_launches += S == 1
    return out


selective_scan_fwd.launches = 0
selective_scan_fwd.single_step_launches = 0


def _check_cotangent(name, g, shape, like):
    if g.device != like.device:
        raise ValueError(f"{name} is on {g.device}, dt on {like.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(g.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(g.shape)}, want {shape}")


def selective_scan_bwd(dt, A, Bmat, Cmat, x, h0, gy, ghT, ckpt=None):
    """The scan's gradients for the cotangents ``gy`` [B, S, d] of y and
    ``ghT`` [B, d, N] of hT (None: zeros), all float32 -> (ddt, dA, dB,
    dC, dx, dh0) in the inputs' shapes.  ``ckpt`` is the forward's chunk
    checkpoints (``selective_scan_fwd(..., checkpoints=True)``); without
    them the wrapper first launches the checkpointing forward itself,
    counted in ``selective_scan_bwd.own_checkpoint_launches`` and not in
    ``selective_scan_fwd.launches``.  On the card it also holds
    [2, blocks, B, S, N] partial sums of dB and dC while it runs, one row
    per block of 64 channels."""
    if dt.device.type == "cpu":
        return ref.selective_scan_bwd(dt, A, Bmat, Cmat, x, h0, gy, ghT,
                                      ckpt)
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    _check_cuda(dt, A, Bmat, Cmat, x, h0)
    B, S, d = dt.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32, device=dt.device)
    gy = torch.zeros((B, S, d), **f32) if gy is None else gy
    ghT = torch.zeros((B, d, N), **f32) if ghT is None else ghT
    _check_cotangent("gy", gy, (B, S, d), dt)
    _check_cotangent("ghT", ghT, (B, d, N), dt)
    if B == 0 or d == 0:
        return (torch.zeros_like(dt), torch.zeros_like(A),
                torch.zeros_like(Bmat), torch.zeros_like(Cmat),
                torch.zeros_like(x), ghT.clone())
    if ckpt is None:
        ckpt = _forward(dt, A, Bmat, Cmat, x, h0, True)[2]
        selective_scan_bwd.own_checkpoint_launches += 1
    _check_cotangent("ckpt", ckpt, (B, -(-S // checkpoint_steps(N)), d, N),
                     dt)
    lib = build.load("selective_scan_bwd")
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC = torch.empty_like(Bmat), torch.empty_like(Cmat)
    dA, dh0 = torch.empty_like(A), torch.empty_like(h0)
    blocks = lib.selective_scan_bwd_blocks(d)
    part = torch.empty((2, blocks, B, S, N), **f32)
    dA_part = torch.empty((B, d, N), **f32)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        code = lib.selective_scan_bwd_launch(
            dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
            x.data_ptr(), gy.data_ptr(), ghT.data_ptr(), ckpt.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dx.data_ptr(), dh0.data_ptr(), part.data_ptr(),
            dA_part.data_ptr(), B, S, d, N, stream)
    build.check(lib, "selective_scan_bwd", code)
    selective_scan_bwd.launches += 1
    return ddt, dA, dB, dC, dx, dh0


selective_scan_bwd.launches = 0
selective_scan_bwd.own_checkpoint_launches = 0
