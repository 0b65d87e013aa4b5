"""Wrappers of the Hopper fused softmax cross-entropy kernels: the forward
(``csrc/fused_xent.cu``), which replaces the reference's
``repro/kernels/fused_xent.py`` ``fused_softmax_xent_fwd``, and the
backward (``csrc/fused_xent_bwd.cu``), which computes on the card the vjp
that the reference's ``_fx_bwd`` recomputes through ``ref.softmax_xent``.

A CPU tensor goes to the plain versions (``kernels.ref.softmax_xent_lse``,
``ref.softmax_xent_bwd``); a CUDA tensor launches a kernel or raises.  The
forward routes by dtype and alignment, never by a ``try``: bfloat16 h and W
with d and V multiples of 8 and 16-byte aligned pointers (TMA's rules,
``tensor_core_route``) take the tensor cores (wgmma + TMA); float32 (kept
off the tensor cores, as ``device.py`` keeps TF32 off) and the other
bfloat16 shapes take the CUDA-core kernel.  The backward kernels take the
tensor-core route only; ``kernels.ops.fused_softmax_xent`` recomputes the
other routes' gradients through the plain version.

``fused_softmax_xent_fwd.launches`` counts the forward calls that launched
(two kernels each: the partial pass over the vocabulary splits and their
merge), ``.tensor_core_launches`` those on the tensor cores;
``fused_softmax_xent_bwd.launches`` and ``.tensor_core_launches`` count the
backward calls (three kernels each: dlogits, dh and dW).
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


def tensor_core_route(h, W) -> bool:
    """True iff the kernels take h and W on the tensor cores: bfloat16
    CUDA tensors, d and V multiples of 8 and both data pointers 16-byte
    aligned (TMA's stride and address rules)."""
    return (h.device.type == "cuda" and h.dtype == torch.bfloat16
            and W.dtype == torch.bfloat16 and h.dim() == 2 and W.dim() == 2
            and h.shape[1] % 8 == 0 and W.shape[1] % 8 == 0
            and h.data_ptr() % 16 == 0 and W.data_ptr() % 16 == 0)


def fused_softmax_xent_fwd_lse(h, W, labels):
    """h: [T, d]; W: [d, V] (float32 or bfloat16, one dtype); labels: [T]
    int32 -> (per-row loss [T], lse [T]) float32: ``lse = logsumexp(h @ W)``
    and ``loss = lse - (h @ W)[label]``, with the product in float32 and
    the [T, V] logits never stored."""
    if h.device.type == "cpu":
        return ref.softmax_xent_lse(h, W, labels)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    _check_cuda(h, W, labels)
    T, d = h.shape
    V = W.shape[1]
    loss = torch.empty((T,), dtype=torch.float32, device=h.device)
    lse = torch.empty((T,), dtype=torch.float32, device=h.device)
    if T == 0:
        return loss, lse
    tc = tensor_core_route(h, W)
    n_sm = torch.cuda.get_device_properties(h.device).multi_processor_count
    split = n_splits(T, V, n_sm)
    part = torch.empty((3, split, T), dtype=torch.float32, device=h.device)
    lib = build.load("fused_xent")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = lib.fused_xent_fwd_launch(
            h.data_ptr(), W.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), part.data_ptr(), T, d, V, split,
            _DTYPES[h.dtype], int(tc), stream)
    build.check(lib, "fused_xent_fwd", code)
    fused_softmax_xent_fwd.launches += 1
    fused_softmax_xent_fwd.tensor_core_launches += tc
    return loss, lse


def fused_softmax_xent_fwd(h, W, labels):
    """h: [T, d]; W: [d, V] (float32 or bfloat16, one dtype); labels: [T]
    int32 -> per-row loss [T] float32, ``logsumexp(h @ W) - (h @ W)[label]``
    with the product in float32 and the [T, V] logits never stored."""
    return fused_softmax_xent_fwd_lse(h, W, labels)[0]


fused_softmax_xent_fwd.launches = 0
fused_softmax_xent_fwd.tensor_core_launches = 0


def fused_softmax_xent_bwd(h, W, labels, lse, g):
    """Gradients of ``sum(g * fused_softmax_xent_fwd(h, W, labels))`` from
    the forward's lse [T] and the loss cotangent g [T] (both float32):
    (dh [T, d], dW [d, V]) in h's and W's dtypes, every product in
    float32.  A CUDA tensor must take the tensor-core route
    (``tensor_core_route``); the kernel splits dlogits into bf16 hi + lo
    and rounds each gradient once (``ref.softmax_xent_bwd_tc`` models it)."""
    if h.device.type == "cpu":
        return ref.softmax_xent_bwd(h, W, labels, lse, g)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    _check_cuda(h, W, labels)
    T, d = h.shape
    V = W.shape[1]
    for name, t in (("lse", lse), ("g", g)):
        if (t.device != h.device or t.dtype != torch.float32
                or tuple(t.shape) != (T,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{T}] "
                             f"tensor on {h.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not tensor_core_route(h, W):
        raise ValueError(
            "the backward kernels take bfloat16 h and W with d and V "
            "multiples of 8 and 16-byte aligned pointers, got "
            f"{h.dtype} h {tuple(h.shape)} and W {tuple(W.shape)}")
    dh = torch.empty_like(h)
    dW = torch.empty_like(W)
    if T == 0:
        return dh, dW.zero_()
    Tp = -(-T // 8) * 8
    if Tp == T:
        hT = h.t().contiguous()
    else:
        hT = torch.zeros((d, Tp), dtype=h.dtype, device=h.device)
        hT[:, :T] = h.t()
    hi = torch.empty((T, V), dtype=torch.bfloat16, device=h.device)
    lo = torch.empty_like(hi)
    lib = build.load("fused_xent_bwd")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = lib.fused_xent_bwd_launch(
            h.data_ptr(), hT.data_ptr(), W.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), g.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            dh.data_ptr(), dW.data_ptr(), T, Tp, d, V, stream)
    build.check(lib, "fused_xent_bwd", code)
    fused_softmax_xent_bwd.launches += 1
    fused_softmax_xent_bwd.tensor_core_launches += 1
    return dh, dW


fused_softmax_xent_bwd.launches = 0
fused_softmax_xent_bwd.tensor_core_launches = 0
