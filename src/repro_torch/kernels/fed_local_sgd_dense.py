"""Wrapper of the Hopper dense-MLP local-SGD kernel
(``csrc/fed_local_sgd_dense.cu``).

A CPU tensor goes to the plain version (``kernels.ref``); a CUDA tensor
launches the kernel, one thread-block cluster per client, or raises (also
when no cluster size fits the shape, or the cluster cannot be resident).
``fed_local_sgd_dense.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fed_local_sgd import (max_clusters, padded_rows,
                                               pick_cluster_size,
                                               rows_per_cta, warps_per_cta)


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


def smem_bytes(d: int, H: int, C: int, B: int, cs: int,
               prox: bool) -> int:
    """The kernel's dynamic shared memory per CTA at cluster size ``cs``
    (the layout of ``csrc/fed_local_sgd_dense.cu``): R rows of w1 (and of
    w10 with prox), the batch rows [2, BP, R] (BP = ``padded_rows(B)``),
    the published first-layer partials [2, B*H + 1], w2 with an odd row
    stride (and w20 with prox), b1, b10, b2, b20, h and dpre [BP, H],
    logits/err [BP, C], the row losses [BP], the warps' prox shares,
    labels and indices [2, B] each, each segment padded to 4 floats."""
    R = rows_per_cta(d, cs)
    nw = warps_per_cta(R, B)
    BP = padded_rows(B)

    def a4(n):
        return 4 * -(-n // 4)
    copies = 2 if prox else 1
    floats = (a4(R * H) * copies + a4(2 * BP * R) + 2 * a4(B * H + 1)
              + a4(H * (C | 1)) * copies + 2 * a4(H) + 2 * a4(C)
              + 2 * a4(BP * H) + a4(BP * C) + a4(BP) + a4(nw)
              + 2 * a4(2 * B))
    return 4 * floats


def checked_cluster_size(K: int, d: int, H: int, C: int, B: int,
                         prox: bool, cluster=None) -> int:
    """The cluster size the dense kernel launches with at these shapes."""
    return pick_cluster_size(
        "fed_local_sgd_dense", K, d,
        lambda cs: smem_bytes(d, H, C, B, cs, prox),
        f"d={d}, H={H}, C={C}, B={B}, prox={prox}", cluster)


def fed_local_sgd_dense(x, y, idx, w1, b1, w2, b2, ns, n_iters, lr: float,
                        prox_mu: float = 0.0, cluster=None):
    """x: [K, max_n, d] f32; y: [K, max_n] i32; idx: [K, max_iters, B] i32
    minibatch indices; w1: [d, H]; b1: [H]; w2: [H, C]; b2: [C]; ns/n_iters:
    [K] i32 -> (w1_k [K, d, H], b1_k [K, H], w2_k [K, H, C], b2_k [K, C],
    losses [K] f32).  ``cluster`` sets the kernel's cluster size (default:
    ``checked_cluster_size``'s choice)."""
    if x.device.type == "cpu":
        return ref.fed_local_sgd_dense(x, y, idx, w1, b1, w2, b2, ns,
                                       n_iters, lr=lr, prox_mu=prox_mu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda(x, y, idx, w1, b1, w2, b2, ns, n_iters)
    K, max_n, d = x.shape
    max_iters, B = idx.shape[1], idx.shape[2]
    H, C = w2.shape
    prox = float(prox_mu) != 0.0
    cs = checked_cluster_size(K, d, H, C, B, prox, cluster)
    smem = smem_bytes(d, H, C, B, cs, prox)
    dev = x.device
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((K, d, H), (K, H), (K, H, C), (K, C), (K,))]
    if K == 0:
        return tuple(outs)
    lib = build.load("fed_local_sgd_dense")
    R = rows_per_cta(d, cs)
    nw = warps_per_cta(R, B)
    if lib.fed_local_sgd_dense_smem_bytes(H, C, B, R, nw, int(prox)) != smem:
        raise RuntimeError("shared-memory layout of fed_local_sgd_dense.cu "
                           "and its wrapper disagree")
    with torch.cuda.device(dev):
        if max_clusters("fed_local_sgd_dense", "fed_local_sgd_dense", B, cs,
                        nw, smem) < 1:
            raise RuntimeError(
                f"fed_local_sgd_dense: a cluster of {cs} CTAs x {32 * nw} "
                f"threads x {smem} bytes of shared memory cannot be resident "
                f"(K={K}, d={d}, H={H}, C={C}, B={B})")
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fed_local_sgd_dense_launch(
            *(t.data_ptr() for t in (x, y, idx, w1, b1, w2, b2, ns,
                                     n_iters, *outs)),
            K, max_n, d, H, C, max_iters, B, cs, R, nw, float(lr),
            float(prox_mu), stream)
    build.check(lib, "fed_local_sgd_dense", code)
    fed_local_sgd_dense.launches += 1
    return tuple(outs)


fed_local_sgd_dense.launches = 0
