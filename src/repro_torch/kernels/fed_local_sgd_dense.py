"""Wrapper of the Hopper dense-MLP local-SGD kernel
(``csrc/fed_local_sgd_dense.cu``).

A CPU tensor goes to the plain version (``kernels.ref``); a CUDA tensor
launches the kernel or raises.  ``fed_local_sgd_dense.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fed_local_sgd import SMEM_LIMIT, THREADS


def _check_cuda(x, y, idx, w1, b1, w2, b2, ns, n_iters):
    dev = x.device
    named = (("x", x), ("y", y), ("idx", idx), ("w1", w1), ("b1", b1),
             ("w2", w2), ("b2", b2), ("ns", ns), ("n_iters", n_iters))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:1] + named[3:7]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in named[1:3] + named[7:]:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if x.dim() != 3 or idx.dim() != 3 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("need x [K, max_n, d], idx [K, max_iters, B], "
                         "w1 [d, H], w2 [H, C]")
    K, max_n, d = x.shape
    H, C = w2.shape
    if (y.shape != (K, max_n) or idx.shape[0] != K or w1.shape != (d, H)
            or b1.shape != (H,) or b2.shape != (C,) or ns.shape != (K,)
            or n_iters.shape != (K,)):
        raise ValueError(
            f"inconsistent shapes: x {tuple(x.shape)}, y {tuple(y.shape)}, "
            f"idx {tuple(idx.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}, ns {tuple(ns.shape)}, "
            f"n_iters {tuple(n_iters.shape)}")
    if max_n < 1 or idx.shape[2] < 1:
        raise ValueError("max_n and the batch size must be >= 1")


def split_count(d: int, H: int) -> int:
    """S, the number of slices each hidden unit's d-long dot product is
    split into, so that about THREADS threads share the first layer."""
    return max(1, min(THREADS // max(H, 1), d))


def smem_bytes(d: int, H: int, C: int, B: int) -> int:
    """The kernel's dynamic shared memory: xb, w2, b1, b2, the first
    layer's partial sums, h, dpre, logits/err, row losses, the prox
    reduction, batch indices and labels.  w1 stays in global memory."""
    S = split_count(d, H)
    return 4 * (B * d + H * C + H + C + S * B * H + 2 * B * H + B * C + B
                + THREADS) + 8 * B


def checked_smem_bytes(d: int, H: int, C: int, B: int) -> int:
    """``smem_bytes``, raising if a Hopper block cannot have that much."""
    smem = smem_bytes(d, H, C, B)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fed_local_sgd_dense needs {smem} bytes of shared memory for "
            f"d={d}, H={H}, C={C}, B={B}; a Hopper block has {SMEM_LIMIT}")
    return smem


def fed_local_sgd_dense(x, y, idx, w1, b1, w2, b2, ns, n_iters, lr: float,
                        prox_mu: float = 0.0):
    """x: [K, max_n, d] f32; y: [K, max_n] i32; idx: [K, max_iters, B] i32
    minibatch indices; w1: [d, H]; b1: [H]; w2: [H, C]; b2: [C]; ns/n_iters:
    [K] i32 -> (w1_k [K, d, H], b1_k [K, H], w2_k [K, H, C], b2_k [K, C],
    losses [K] f32)."""
    if x.device.type == "cpu":
        return ref.fed_local_sgd_dense(x, y, idx, w1, b1, w2, b2, ns,
                                       n_iters, lr=lr, prox_mu=prox_mu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda(x, y, idx, w1, b1, w2, b2, ns, n_iters)
    K, max_n, d = x.shape
    max_iters, B = idx.shape[1], idx.shape[2]
    H, C = w2.shape
    smem = checked_smem_bytes(d, H, C, B)
    dev = x.device
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((K, d, H), (K, H), (K, H, C), (K, C), (K,))]
    if K == 0:
        return tuple(outs)
    lib = build.load("fed_local_sgd_dense")
    S = split_count(d, H)
    if lib.fed_local_sgd_dense_smem_bytes(d, H, C, B, S) != smem:
        raise RuntimeError("shared-memory layout of fed_local_sgd_dense.cu "
                           "and its wrapper disagree")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fed_local_sgd_dense_launch(
            *(t.data_ptr() for t in (x, y, idx, w1, b1, w2, b2, ns,
                                     n_iters, *outs)),
            K, max_n, d, H, C, max_iters, B, S, float(lr), float(prox_mu),
            stream)
    build.check(lib, "fed_local_sgd_dense", code)
    fed_local_sgd_dense.launches += 1
    return tuple(outs)


fed_local_sgd_dense.launches = 0
