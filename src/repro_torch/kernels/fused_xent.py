"""Wrapper of the Hopper fused softmax cross-entropy kernel
(``csrc/fused_xent.cu``), which replaces the reference's
``repro/kernels/fused_xent.py`` ``fused_softmax_xent_fwd``.

A CPU tensor goes to the plain version (``kernels.ref.softmax_xent``); a
CUDA tensor launches the kernel or raises.
``fused_softmax_xent_fwd.launches`` counts the calls that launched it (two
kernels each: the partial pass over the vocabulary splits and their
merge).  Forward only: the backward recomputes through the plain version
(``kernels.ops.fused_softmax_xent``), as the reference's ``_fx_bwd`` does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: vocabulary columns per tile and rows per block of the partial kernel
#: (BV and BR in csrc/fused_xent.cu, which refuses a split count above
#: its tile count)
BLOCK_V = 128
BLOCK_ROWS = 128


def n_splits(T: int, V: int, n_sm: int) -> int:
    """Vocabulary splits of the grid: about four blocks per SM over the
    ceil(T / 128) row tiles, at least 1 and at most one 128-column tile
    each."""
    n_vt = max(1, math.ceil(V / BLOCK_V))
    n_rt = max(1, math.ceil(T / BLOCK_ROWS))
    return max(1, min(n_vt, math.ceil(4 * n_sm / n_rt)))


def _check_cuda(h, W, labels):
    if W.device != h.device or labels.device != h.device:
        raise ValueError(f"h, W and labels must share a device, got "
                         f"{h.device}, {W.device}, {labels.device}")
    if h.dtype not in _DTYPES or W.dtype != h.dtype:
        raise TypeError(f"h and W must both be float32 or bfloat16, got "
                        f"{h.dtype} and {W.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if h.dim() != 2 or W.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"need h [T, d], W [d, V], labels [T], got "
                         f"{tuple(h.shape)}, {tuple(W.shape)}, "
                         f"{tuple(labels.shape)}")
    if W.shape[0] != h.shape[1] or labels.shape[0] != h.shape[0]:
        raise ValueError(f"shapes do not match: h {tuple(h.shape)}, W "
                         f"{tuple(W.shape)}, labels {tuple(labels.shape)}")
    if W.shape[1] == 0:
        raise ValueError("the vocabulary is empty")
    if math.ceil(h.shape[0] / BLOCK_ROWS) > 2 ** 31 - 1:
        raise ValueError(f"T={h.shape[0]} exceeds the grid")
    for name, t in (("h", h), ("W", W), ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_softmax_xent_fwd(h, W, labels):
    """h: [T, d]; W: [d, V] (float32 or bfloat16, one dtype); labels: [T]
    int32 -> per-row loss [T] float32, ``logsumexp(h @ W) - (h @ W)[label]``
    with the product in float32 and the [T, V] logits never stored."""
    if h.device.type == "cpu":
        return ref.softmax_xent(h, W, labels)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    _check_cuda(h, W, labels)
    T, d = h.shape
    V = W.shape[1]
    loss = torch.empty((T,), dtype=torch.float32, device=h.device)
    if T == 0:
        return loss
    n_sm = torch.cuda.get_device_properties(h.device).multi_processor_count
    split = n_splits(T, V, n_sm)
    part = torch.empty((3, split, T), dtype=torch.float32, device=h.device)
    lib = build.load("fused_xent")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = lib.fused_xent_fwd_launch(
            h.data_ptr(), W.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            part.data_ptr(), T, d, V, split, _DTYPES[h.dtype], stream)
    build.check(lib, "fused_xent_fwd", code)
    fused_softmax_xent_fwd.launches += 1
    return loss


fused_softmax_xent_fwd.launches = 0
