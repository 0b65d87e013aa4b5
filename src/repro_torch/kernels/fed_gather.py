"""Wrapper of the Hopper cohort-gather kernel (``csrc/fed_gather.cu``).

A CPU tensor goes to the plain version (``kernels.ref``); a CUDA tensor
launches the kernel or raises.  ``fed_cohort_gather.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_WORD_DTYPES = (torch.float32, torch.int32)


def _check_cuda(flat_x, flat_y, starts, ns, max_n: int):
    dev = flat_x.device
    for name, t in (("flat_y", flat_y), ("starts", starts), ("ns", ns)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, flat_x on {dev}")
    if flat_x.dtype not in _WORD_DTYPES:
        raise TypeError(f"flat_x must be float32 or int32, got "
                        f"{flat_x.dtype}")
    for name, t in (("flat_y", flat_y), ("starts", starts), ("ns", ns)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if flat_x.dim() != 2 or flat_y.dim() != 1 \
            or flat_y.shape[0] != flat_x.shape[0]:
        raise ValueError(f"need flat_x [rows, feat] and flat_y [rows], got "
                         f"{tuple(flat_x.shape)} and {tuple(flat_y.shape)}")
    if starts.dim() != 1 or ns.shape != starts.shape:
        raise ValueError("starts and ns must both be [K]")
    if not 0 < max_n <= flat_x.shape[0]:
        raise ValueError(f"max_n={max_n} must be in [1, rows="
                         f"{flat_x.shape[0]}]")
    for name, t in (("flat_x", flat_x), ("flat_y", flat_y),
                    ("starts", starts), ("ns", ns)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fed_cohort_gather(flat_x, flat_y, starts, ns, max_n: int):
    """flat_x: [rows, feat] f32|i32; flat_y: [rows] i32; starts/ns: [K]
    i32 -> (x [K, max_n, feat], y [K, max_n] i32, mask [K, max_n] f32)."""
    if flat_x.device.type == "cpu":
        return ref.fed_cohort_gather(flat_x, flat_y, starts, ns, max_n=max_n)
    if flat_x.device.type != "cuda":
        raise ValueError(f"unsupported device {flat_x.device}")
    _check_cuda(flat_x, flat_y, starts, ns, max_n)
    rows, feat = flat_x.shape
    K = starts.shape[0]
    dev = flat_x.device
    x = torch.empty((K, max_n, feat), dtype=flat_x.dtype, device=dev)
    y = torch.empty((K, max_n), dtype=torch.int32, device=dev)
    mask = torch.empty((K, max_n), dtype=torch.float32, device=dev)
    if K == 0:
        return x, y, mask
    # the kernel sizes its grid to the card: at most 8 blocks per SM
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = build.load("fed_gather")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fed_cohort_gather_launch(
            flat_x.data_ptr(), flat_y.data_ptr(), starts.data_ptr(),
            ns.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(),
            rows, feat, K, max_n, n_sm, stream)
    build.check(lib, "fed_cohort_gather", code)
    fed_cohort_gather.launches += 1
    return x, y, mask


fed_cohort_gather.launches = 0
