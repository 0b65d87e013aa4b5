"""Wrapper of the Hopper MCLR local-SGD kernel (``csrc/fed_local_sgd.cu``).

A CPU tensor goes to the plain version (``kernels.ref``); a CUDA tensor
launches the kernel, one thread-block cluster per client, or raises (also
when no cluster size fits the shape, or the cluster cannot be resident).
``fed_local_sgd_mclr.launches`` counts the kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref

MAX_THREADS = 512              # the kernel's __launch_bounds__
SMEM_LIMIT = 232448            # 227 KB: a Hopper block's shared-memory cap
SMS = 132                      # the H100 SXM's streaming multiprocessors
CLUSTER_SIZES = (1, 2, 4, 8)   # portable thread-block cluster sizes
MIN_ROWS = 64                  # fewer rows per CTA than this: no more split


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def rows_per_cta(d: int, cs: int) -> int:
    """R, the rows of w (w1) each CTA of a cluster of ``cs`` owns: d / cs
    rounded up to a multiple of 4 (the kernels read rows as float4)."""
    return 4 * _ceil(_ceil(d, cs), 4)


def warps_per_cta(R: int, B: int) -> int:
    """About 8 rows per warp, and two warps more than batch rows (the
    softmax runs a row per warp, the warps left over fetch the next step's
    rows meanwhile), at most MAX_THREADS / 32."""
    return max(1, min(MAX_THREADS // 32, max(_ceil(R, 8), B + 2)))


def padded_rows(B: int) -> int:
    """B rounded up to the kernels' register chunks of 4, 10 or 16 rows
    (``rows_in_registers`` in the sources): the batch-row buffers carry
    zero rows up to it."""
    rb = 4 if B <= 4 else 10 if B <= 10 else 16
    return rb * _ceil(B, rb)


def choose_cluster_size(K: int, d: int, fits) -> int:
    """The cluster size for K clients of d features: the smallest size in
    CLUSTER_SIZES whose per-CTA shared memory ``fits(cs)``, grown while the
    K clusters still fit the card's SMs one CTA each (K * cs <= SMS) and
    each CTA keeps at least MIN_ROWS rows."""
    sizes = [cs for cs in CLUSTER_SIZES if fits(cs)]
    if not sizes:
        return 0
    best = sizes[0]
    for cs in sizes[1:]:
        if K * cs > SMS or _ceil(d, cs) < MIN_ROWS:
            break
        best = cs
    return best


def smem_bytes(d: int, C: int, B: int, cs: int, prox: bool) -> int:
    """The kernel's dynamic shared memory per CTA at cluster size ``cs``
    (the layout of ``csrc/fed_local_sgd.cu``): R rows of w (and of w0 with
    prox), the batch rows [2, BP, R] (BP = ``padded_rows(B)``), the
    published partial logits [2, B*C + 1], logits/err [BP, C], b and b0,
    the row losses [BP], the warps' prox shares, labels and indices [2, B]
    each, each segment padded to 4 floats."""
    R = rows_per_cta(d, cs)
    nw = warps_per_cta(R, B)
    BP = padded_rows(B)

    def a4(n):
        return 4 * _ceil(n, 4)
    floats = (a4(R * C) * (2 if prox else 1) + a4(2 * BP * R)
              + 2 * a4(B * C + 1) + a4(BP * C) + 2 * a4(C)
              + a4(BP) + a4(nw) + 2 * a4(2 * B))
    return 4 * floats


def pick_cluster_size(kernel: str, K: int, d: int, smem, shape: str,
                      cluster=None) -> int:
    """``cluster``, or by default ``choose_cluster_size(K, d, ...)``, for
    a kernel whose CTAs need ``smem(cs)`` bytes; raises if it is not a
    cluster size or its CTAs cannot have that much shared memory."""
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"{kernel}: cluster size {cluster} is not one of "
                         f"{CLUSTER_SIZES}")

    def fits(cs):
        return smem(cs) <= SMEM_LIMIT
    cs = choose_cluster_size(K, d, fits) if cluster is None else cluster
    if not cs or not fits(cs):
        tried = cs or CLUSTER_SIZES[-1]
        raise ValueError(
            f"{kernel}: {shape} needs {smem(tried)} bytes of shared memory "
            f"per CTA at cluster size {tried}; a Hopper block has "
            f"{SMEM_LIMIT}")
    return cs


@functools.lru_cache(maxsize=None)
def max_clusters(source: str, kernel: str, B: int, cs: int, nw: int,
                 smem: int) -> int:
    """How many clusters of ``cs`` CTAs of ``kernel`` can be resident at
    once (the card's ``cudaOccupancyMaxActiveClusters``)."""
    lib = build.load(source)
    n = getattr(lib, f"{kernel}_max_clusters")(B, cs, nw, smem)
    if n < 0:
        build.check(lib, kernel, -n)
    return n


def checked_cluster_size(K: int, d: int, C: int, B: int, prox: bool,
                         cluster=None) -> int:
    """The cluster size the MCLR kernel launches with at these shapes."""
    return pick_cluster_size(
        "fed_local_sgd_mclr", K, d,
        lambda cs: smem_bytes(d, C, B, cs, prox),
        f"d={d}, C={C}, B={B}, prox={prox}", cluster)


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


def fed_local_sgd_mclr(x, y, idx, w0, b0, ns, n_iters, lr: float,
                       prox_mu: float = 0.0, cluster=None):
    """x: [K, max_n, d] f32; y: [K, max_n] i32; idx: [K, max_iters, B] i32
    minibatch indices; w0: [d, C]; b0: [C]; ns/n_iters: [K] i32 ->
    (w_k [K, d, C], b_k [K, C], losses [K] f32).  ``cluster`` sets the
    kernel's cluster size (default: ``checked_cluster_size``'s choice)."""
    if x.device.type == "cpu":
        return ref.fed_local_sgd_mclr(x, y, idx, w0, b0, ns, n_iters, lr=lr,
                                      prox_mu=prox_mu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda(x, y, idx, w0, b0, ns, n_iters)
    K, max_n, d = x.shape
    max_iters, B = idx.shape[1], idx.shape[2]
    C = w0.shape[1]
    prox = float(prox_mu) != 0.0
    cs = checked_cluster_size(K, d, C, B, prox, cluster)
    smem = smem_bytes(d, C, B, cs, prox)
    dev = x.device
    w = torch.empty((K, d, C), dtype=torch.float32, device=dev)
    b = torch.empty((K, C), dtype=torch.float32, device=dev)
    losses = torch.empty((K,), dtype=torch.float32, device=dev)
    if K == 0:
        return w, b, losses
    lib = build.load("fed_local_sgd")
    R = rows_per_cta(d, cs)
    nw = warps_per_cta(R, B)
    if lib.fed_local_sgd_mclr_smem_bytes(C, B, R, nw, int(prox)) != smem:
        raise RuntimeError("shared-memory layout of fed_local_sgd.cu and "
                           "its wrapper disagree")
    with torch.cuda.device(dev):
        if max_clusters("fed_local_sgd", "fed_local_sgd_mclr", B, cs, nw,
                        smem) < 1:
            raise RuntimeError(
                f"fed_local_sgd_mclr: a cluster of {cs} CTAs x {32 * nw} "
                f"threads x {smem} bytes of shared memory cannot be resident "
                f"(K={K}, d={d}, C={C}, B={B})")
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fed_local_sgd_mclr_launch(
            x.data_ptr(), y.data_ptr(), idx.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), ns.data_ptr(), n_iters.data_ptr(), w.data_ptr(),
            b.data_ptr(), losses.data_ptr(), K, max_n, d, C, max_iters, B,
            cs, R, nw, float(lr), float(prox_mu), stream)
    build.check(lib, "fed_local_sgd_mclr", code)
    fed_local_sgd_mclr.launches += 1
    return w, b, losses


fed_local_sgd_mclr.launches = 0
