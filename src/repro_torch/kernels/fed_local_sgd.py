"""Wrapper of the Hopper MCLR local-SGD kernel (``csrc/fed_local_sgd.cu``).

A CPU tensor goes to the plain version (``kernels.ref``); a CUDA tensor
launches the kernel or raises.  ``fed_local_sgd_mclr.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

THREADS = 1024                 # block size fixed in the kernel source
SMEM_LIMIT = 232448            # 227 KB: a Hopper block's shared-memory cap


def _check_cuda(x, y, idx, w0, b0, ns, n_iters):
    dev = x.device
    named = (("x", x), ("y", y), ("idx", idx), ("w0", w0), ("b0", b0),
             ("ns", ns), ("n_iters", n_iters))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("w0", w0), ("b0", b0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("y", y), ("idx", idx), ("ns", ns),
                    ("n_iters", n_iters)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if x.dim() != 3 or idx.dim() != 3 or w0.dim() != 2:
        raise ValueError("need x [K, max_n, d], idx [K, max_iters, B], "
                         "w0 [d, C]")
    K, max_n, d = x.shape
    C = w0.shape[1]
    if (y.shape != (K, max_n) or idx.shape[0] != K or w0.shape[0] != d
            or b0.shape != (C,) or ns.shape != (K,)
            or n_iters.shape != (K,)):
        raise ValueError(
            f"inconsistent shapes: x {tuple(x.shape)}, y {tuple(y.shape)}, "
            f"idx {tuple(idx.shape)}, w0 {tuple(w0.shape)}, "
            f"b0 {tuple(b0.shape)}, ns {tuple(ns.shape)}, "
            f"n_iters {tuple(n_iters.shape)}")
    if max_n < 1 or idx.shape[2] < 1:
        raise ValueError("max_n and the batch size must be >= 1")


def split_count(d: int, C: int, B: int) -> int:
    """P, the number of slices each logit's d-long dot product is split
    into, so that about THREADS threads share the logits."""
    return max(1, min(THREADS // max(B * C, 1), d))


def smem_bytes(d: int, C: int, B: int) -> int:
    """The kernel's dynamic shared memory (w, b, xb, partial logits,
    logits/err, row losses, the prox reduction, batch indices and labels)."""
    P = split_count(d, C, B)
    return 4 * (d * C + C + B * d + P * B * C + B * C + B + THREADS) + 8 * B


def fed_local_sgd_mclr(x, y, idx, w0, b0, ns, n_iters, lr: float,
                       prox_mu: float = 0.0):
    """x: [K, max_n, d] f32; y: [K, max_n] i32; idx: [K, max_iters, B] i32
    minibatch indices; w0: [d, C]; b0: [C]; ns/n_iters: [K] i32 ->
    (w_k [K, d, C], b_k [K, C], losses [K] f32)."""
    if x.device.type == "cpu":
        return ref.fed_local_sgd_mclr(x, y, idx, w0, b0, ns, n_iters, lr=lr,
                                      prox_mu=prox_mu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda(x, y, idx, w0, b0, ns, n_iters)
    K, max_n, d = x.shape
    max_iters, B = idx.shape[1], idx.shape[2]
    C = w0.shape[1]
    smem = smem_bytes(d, C, B)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fed_local_sgd_mclr needs {smem} bytes of shared memory for "
            f"d={d}, C={C}, B={B}; a Hopper block has {SMEM_LIMIT}")
    dev = x.device
    w = torch.empty((K, d, C), dtype=torch.float32, device=dev)
    b = torch.empty((K, C), dtype=torch.float32, device=dev)
    losses = torch.empty((K,), dtype=torch.float32, device=dev)
    if K == 0:
        return w, b, losses
    lib = build.load("fed_local_sgd")
    if lib.fed_local_sgd_mclr_smem_bytes(d, C, B,
                                         split_count(d, C, B)) != smem:
        raise RuntimeError("shared-memory layout of fed_local_sgd.cu and "
                           "its wrapper disagree")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fed_local_sgd_mclr_launch(
            x.data_ptr(), y.data_ptr(), idx.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), ns.data_ptr(), n_iters.data_ptr(), w.data_ptr(),
            b.data_ptr(), losses.data_ptr(), K, max_n, d, C, max_iters, B,
            split_count(d, C, B), float(lr), float(prox_mu), stream)
    build.check(lib, "fed_local_sgd_mclr", code)
    fed_local_sgd_mclr.launches += 1
    return w, b, losses


fed_local_sgd_mclr.launches = 0
