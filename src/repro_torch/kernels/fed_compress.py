"""Wrapper of the Hopper top-k + int8 compression kernel
(``csrc/fed_compress.cu``).

A CPU tensor goes to the plain version (``kernels.ref``); a CUDA tensor
launches the kernel or raises.  ``fed_compress_topk_q8.launches`` counts
the kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


def fed_compress_topk_q8(ef, k: int):
    """ef: [K, P] f32 error-feedback delta rows; ``k`` kept-coordinate count
    -> (q [K, P] int8, zero off the per-row top-k mask; scale [K] f32).
    Bitwise the plain version."""
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
    if P >= 2**31:
        raise ValueError(f"P={P} does not fit the kernel's int indices")
    q = torch.empty((K, P), dtype=torch.int8, device=ef.device)
    scale = torch.zeros((K,), dtype=torch.float32, device=ef.device)
    if K == 0 or P == 0:
        return q, scale
    k = max(-1, min(k, P))       # the kernel's branches: <= 0, >= P
    lib = build.load("fed_compress")
    with torch.cuda.device(ef.device):
        stream = torch.cuda.current_stream(ef.device).cuda_stream
        code = lib.fed_compress_topk_q8_launch(
            ef.data_ptr(), q.data_ptr(), scale.data_ptr(), K, P, k, stream)
    build.check(lib, "fed_compress_topk_q8", code)
    fed_compress_topk_q8.launches += 1
    return q, scale


fed_compress_topk_q8.launches = 0
