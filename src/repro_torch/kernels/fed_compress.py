"""Wrapper of the Hopper top-k + int8 compression kernel
(``csrc/fed_compress.cu``): one thread-block cluster per row.

A CPU tensor goes to the plain version (``kernels.ref``); a CUDA tensor
launches the kernel or raises (also when no cluster of the plan can be
resident).  ``fed_compress_topk_q8.launches`` counts the kernel launches.

The launch plan (``plan``) is pure Python: a cluster of CS CTAs per row,
rank r owning the slice ``slices(P, cs)[r]``; on the ``resident`` route
each CTA holds its slice in shared memory, on the ``streamed`` route (rows
longer than 8 x ``MAX_RESIDENT_SLICE``) it re-reads it from global memory
each sweep.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build, ref

THREADS = 512                  # the kernel's __launch_bounds__
BINS = 4096                    # the widest radix pass (12 bits)
CTL_BYTES = 640                # sizeof(Ctl), the CTA's bookkeeping
SMEM_LIMIT = 232448            # 227 KB: a Hopper block's shared-memory cap
SMS = 132                      # the H100 SXM's streaming multiprocessors
CLUSTER_SIZES = (1, 2, 4, 8)   # portable thread-block cluster sizes
MIN_SLICE = 2048               # fewer coordinates per CTA: no more split
ROUTES = ("resident", "streamed")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def slice_len(P: int, cs: int) -> int:
    """S, the coordinates each CTA of a cluster of ``cs`` owns: P / cs
    rounded up to a multiple of 4."""
    return 4 * _ceil(_ceil(P, cs), 4)


def slices(P: int, cs: int):
    """[lo, hi) of each rank's slice, in rank order (the last ones may be
    empty when P is small)."""
    S = slice_len(P, cs)
    return [(min(r * S, P), min(r * S + S, P)) for r in range(cs)]


def smem_bytes(S: int, resident: bool) -> int:
    """The kernel's dynamic shared memory per CTA (the layout of
    ``csrc/fed_compress.cu``): the bookkeeping, two histograms [BINS]
    and, resident, the slice [S + 4] (alignment padding)."""
    return CTL_BYTES + 8 * BINS + (4 * (S + 4) if resident else 0)


#: the longest slice a CTA holds in shared memory (a multiple of 4), so
#: rows up to 8 x 49,756 = 398,048 coordinates take the resident route
MAX_RESIDENT_SLICE = 4 * ((SMEM_LIMIT - smem_bytes(0, False)) // 16 - 1)


@dataclasses.dataclass(frozen=True)
class Plan:
    route: str       # "resident" or "streamed"
    cs: int          # CTAs per row (the cluster size)
    slice: int       # S, coordinates per CTA
    smem: int        # dynamic shared memory per CTA, bytes


def _plan(route: str, cs: int, P: int) -> Plan:
    S = slice_len(P, cs)
    return Plan(route, cs, S, smem_bytes(S, route == "resident"))


def plan(K: int, P: int, cluster=None, route=None) -> Plan:
    """The launch plan for K rows of P coordinates.

    By default: the resident route where some cluster size fits its slice
    in a CTA's shared memory; its size the smallest that fits, grown while
    each CTA keeps at least MIN_SLICE coordinates and the K clusters stay
    resident on the card at once (K x cs <= SMS: a CTA's 512 threads take
    most of an SM's registers, so an SM holds one).
    Rows that fit at no size take the streamed route at the largest size.
    ``cluster`` and ``route`` force either; a forced plan that cannot run
    raises ValueError."""
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"fed_compress_topk_q8: cluster size {cluster} is "
                         f"not one of {CLUSTER_SIZES}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"fed_compress_topk_q8: route {route!r} is not "
                         f"one of {ROUTES}")
    if P >= 2**31:
        raise ValueError(f"fed_compress_topk_q8: P={P} does not fit the "
                         f"kernel's int indices")
    sizes = CLUSTER_SIZES if cluster is None else (cluster,)
    fits = [cs for cs in sizes if slice_len(P, cs) <= MAX_RESIDENT_SLICE]
    if route == "resident" and not fits:
        cs = sizes[-1]
        raise ValueError(
            f"fed_compress_topk_q8: a row of P={P} needs "
            f"{_plan('resident', cs, P).smem} bytes of shared memory per "
            f"CTA on the resident route at cluster size {cs}; a Hopper "
            f"block has {SMEM_LIMIT}")
    if route == "streamed" or not fits:
        return _plan("streamed", sizes[-1], P)
    best = fits[0]
    for cs in fits[1:]:
        if slice_len(P, cs) < MIN_SLICE or K * cs > SMS:
            break
        best = cs
    return _plan("resident", best, P)


@functools.lru_cache(maxsize=None)
def max_clusters(cs: int, resident: bool, smem: int) -> int:
    """How many clusters of ``cs`` CTAs can be resident at once (the
    card's ``cudaOccupancyMaxActiveClusters``)."""
    lib = build.load("fed_compress")
    n = lib.fed_compress_topk_q8_max_clusters(cs, int(resident), smem)
    if n < 0:
        build.check(lib, "fed_compress_topk_q8", -n)
    return n


def fed_compress_topk_q8(ef, k: int, cluster=None, route=None):
    """ef: [K, P] f32 error-feedback delta rows; ``k`` kept-coordinate count
    -> (q [K, P] int8, zero off the per-row top-k mask; scale [K] f32).
    Bitwise the plain version.  ``cluster`` and ``route`` force the
    kernel's plan (default: ``plan``'s choice)."""
    k = int(k)
    if ef.device.type == "cpu":
        return ref.fed_compress_topk_q8(ef, k=k)
    if ef.device.type != "cuda":
        raise ValueError(f"unsupported device {ef.device}")
    if ef.dtype != torch.float32:
        raise TypeError(f"ef must be float32, got {ef.dtype}")
    if ef.dim() != 2 or not ef.is_contiguous():
        raise ValueError(f"ef must be a contiguous [K, P], got "
                         f"{tuple(ef.shape)}")
    K, P = ef.shape
    pl = plan(K, P, cluster, route)
    q = torch.empty((K, P), dtype=torch.int8, device=ef.device)
    if K == 0 or P == 0:
        return q, torch.zeros((K,), dtype=torch.float32, device=ef.device)
    scale = torch.empty((K,), dtype=torch.float32, device=ef.device)
    k = max(-1, min(k, P))       # the kernel's branches: <= 0, >= P
    lib = build.load("fed_compress")
    resident = pl.route == "resident"
    if lib.fed_compress_topk_q8_smem_bytes(pl.slice,
                                           int(resident)) != pl.smem:
        raise RuntimeError("shared-memory layout of fed_compress.cu and "
                           "its wrapper disagree")
    with torch.cuda.device(ef.device):
        if max_clusters(pl.cs, resident, pl.smem) < 1:
            raise RuntimeError(
                f"fed_compress_topk_q8: a cluster of {pl.cs} CTAs x "
                f"{THREADS} threads x {pl.smem} bytes of shared memory "
                f"cannot be resident (K={K}, P={P}, {pl.route})")
        stream = torch.cuda.current_stream(ef.device).cuda_stream
        code = lib.fed_compress_topk_q8_launch(
            ef.data_ptr(), q.data_ptr(), scale.data_ptr(), K, P, k, pl.cs,
            pl.slice, int(resident), pl.smem, stream)
    build.check(lib, "fed_compress_topk_q8", code)
    fed_compress_topk_q8.launches += 1
    return q, scale


fed_compress_topk_q8.launches = 0
