"""Wrappers of the Hopper fused softmax cross-entropy kernels: the forward
(``csrc/fused_xent.cu``), which replaces the reference's
``repro/kernels/fused_xent.py`` ``fused_softmax_xent_fwd``, and the
backward (``csrc/fused_xent_bwd.cu``), which computes on the card the vjp
that the reference's ``_fx_bwd`` recomputes through ``ref.softmax_xent``.

A CPU tensor goes to the plain versions (``kernels.ref.softmax_xent_lse``,
``ref.softmax_xent_bwd``); a CUDA tensor launches a kernel or raises.  W
[d, V] is read through its row pitch ``W.stride(0)`` (its rows themselves
contiguous), so it may be the ``[:, :V]`` view of a ``[d, ceil8(V)]``
buffer (``pitched``): an odd vocabulary then meets TMA's rule that rows
start 16 bytes apart.  The forward routes by dtype, strides and alignment,
never by a ``try``: bfloat16 h and W with h contiguous, d a multiple of 8,
W's pitch a multiple of 8 and 16-byte aligned pointers
(``tensor_core_route``) take the tensor cores (wgmma + TMA); float32 (kept
off the tensor cores, as ``device.py`` keeps TF32 off) and the other
bfloat16 layouts take the CUDA-core kernel.  The backward kernels take the
tensor-core route only; ``kernels.ops.fused_softmax_xent`` recomputes the
other routes' gradients through the plain version.

``fused_softmax_xent_fwd.launches`` counts the forward calls that launched
(two kernels each: the partial pass over the vocabulary splits and their
merge), ``.tensor_core_launches`` those on the tensor cores;
``fused_softmax_xent_bwd.launches`` and ``.tensor_core_launches`` count the
backward calls (four kernels each: dlogits, the dh product over its
splits of the vocabulary, their sum, and dW).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: vocabulary columns per tile of the CUDA-core partial kernel and of the
#: tensor-core kernels, and rows per block of both (BV, xtc::BN and BR /
#: xtc::BM in csrc/; the forward refuses a split count above its route's
#: tile count)
BLOCK_V = 128
TC_BLOCK_V = 256
BLOCK_ROWS = 128
#: depth of one stage of the tensor-core mainloop (xtc::BK): the dh
#: product's vocabulary is split in whole stages
TC_BLOCK_K = 64
#: wave fill at which ``dh_splits`` stops looking for more splits
DH_FILL = 0.95


def n_splits(T: int, V: int, n_sm: int, block_v: int = BLOCK_V) -> int:
    """Vocabulary splits of the forward's grid: about four blocks per SM
    over the ceil(T / 128) row tiles, at least 1 and at most one
    ``block_v``-column tile each."""
    n_vt = max(1, math.ceil(V / block_v))
    n_rt = max(1, math.ceil(T / BLOCK_ROWS))
    return max(1, min(n_vt, math.ceil(4 * n_sm / n_rt)))


def dh_splits(T: int, d: int, V: int, n_sm: int) -> int:
    """Splits of the vocabulary (the depth) of the backward's dh product:
    its (128-row, 256-column) tiles times the splits are the persistent
    grid's work items, so the smallest count whose items fill their last
    wave of ``n_sm`` to ``DH_FILL`` or more (Llama's chunk: 96 tiles, 4
    splits, 384 items in 3 waves of 132), else the fullest, at most one
    64-deep stage a split."""
    tiles = math.ceil(T / BLOCK_ROWS) * math.ceil(d / TC_BLOCK_V)
    best, best_fill = 1, 0.0
    for s in range(1, max(1, math.ceil(V / TC_BLOCK_K)) + 1):
        items = tiles * s
        fill = items / (math.ceil(items / n_sm) * n_sm)
        if fill >= DH_FILL:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


def pitch(V: int) -> int:
    """The row pitch (elements) of a pitched [*, V] bf16 buffer: V rounded
    up to a multiple of 8, so that rows start 16 bytes apart."""
    return -(-V // 8) * 8


def pitched(W, dtype=None):
    """W [d, V] copied (cast to ``dtype``, by default W's) into a
    ``[d, pitch(V)]`` buffer with one ``copy_``, returned as its
    ``[:, :V]`` view.  The pad columns are left as they come: no kernel
    reads them."""
    d, V = W.shape
    buf = torch.empty((d, pitch(V)), dtype=dtype or W.dtype, device=W.device)
    return buf[:, :V].copy_(W)


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
    for name, t in (("h", h), ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not _rows_ok(W):
        raise ValueError(f"W's rows must be contiguous and at least V "
                         f"elements apart, got strides {W.stride()} for "
                         f"shape {tuple(W.shape)}")


def _rows_ok(W) -> bool:
    return W.stride(1) == 1 and W.stride(0) >= W.shape[1]


def tensor_core_route(h, W) -> bool:
    """True iff the kernels take h and W on the tensor cores: bfloat16
    CUDA tensors, h contiguous with d a multiple of 8, W's rows contiguous
    and a multiple of 8 elements (and at least V) apart, and both data
    pointers 16-byte aligned (TMA's stride and address rules).  A pitched
    W (``pitched``) meets them whatever V is.  Meta tensors (the dry-run's
    shapes, ``roofline.costs``) take the route their dtypes and strides
    would take on the card."""
    if h.device.type == "meta":
        aligned = True
    elif h.device.type == "cuda":
        aligned = h.data_ptr() % 16 == 0 and W.data_ptr() % 16 == 0
    else:
        return False
    return (aligned and h.dtype == torch.bfloat16
            and W.dtype == torch.bfloat16 and h.dim() == 2 and W.dim() == 2
            and h.is_contiguous() and h.shape[1] % 8 == 0 and _rows_ok(W)
            and W.stride(0) % 8 == 0)


def fused_softmax_xent_fwd_lse(h, W, labels):
    """h: [T, d]; W: [d, V] (float32 or bfloat16, one dtype; its rows
    contiguous, any pitch); labels: [T] int32 -> (per-row loss [T], lse
    [T]) float32: ``lse = logsumexp(h @ W)`` and
    ``loss = lse - (h @ W)[label]``, with the product in float32 and the
    [T, V] logits never stored."""
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
    split = n_splits(T, V, n_sm, TC_BLOCK_V if tc else BLOCK_V)
    part = torch.empty((3, split, T), dtype=torch.float32, device=h.device)
    lib = build.load("fused_xent")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = lib.fused_xent_fwd_launch(
            h.data_ptr(), W.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), part.data_ptr(), T, d, V, W.stride(0), split,
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
    and rounds each gradient once (``ref.softmax_xent_bwd_tc`` models it).
    On the card dW is the ``[:, :V]`` view of a ``[d, pitch(V)]``
    buffer."""
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
            "the backward kernels take bfloat16 h and W with d a multiple "
            "of 8, W's rows a multiple of 8 elements apart and 16-byte "
            f"aligned pointers, got {h.dtype} h {tuple(h.shape)} and W "
            f"{tuple(W.shape)} with strides {W.stride()}")
    ldg = pitch(V)
    dh = torch.empty_like(h)
    dW = torch.empty((d, ldg), dtype=W.dtype, device=h.device)[:, :V]
    if T == 0:
        return dh, dW.zero_()
    Tp = -(-T // 8) * 8
    if Tp == T:
        hT = h.t().contiguous()
    else:
        hT = torch.zeros((d, Tp), dtype=h.dtype, device=h.device)
        hT[:, :T] = h.t()
    hi = torch.empty((T, ldg), dtype=torch.bfloat16, device=h.device)
    lo = torch.empty_like(hi)
    n_sm = torch.cuda.get_device_properties(h.device).multi_processor_count
    split = dh_splits(T, d, V, n_sm)
    ws = torch.empty((split, T, d), dtype=torch.float32, device=h.device)
    lib = build.load("fused_xent_bwd")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = lib.fused_xent_bwd_launch(
            h.data_ptr(), hT.data_ptr(), W.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), g.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            ws.data_ptr(), dh.data_ptr(), dW.data_ptr(), T, Tp, d, V,
            W.stride(0), ldg, split, stream)
    build.check(lib, "fused_xent_bwd", code)
    fused_softmax_xent_bwd.launches += 1
    fused_softmax_xent_bwd.tensor_core_launches += 1
    return dh, dW


fused_softmax_xent_bwd.launches = 0
fused_softmax_xent_bwd.tensor_core_launches = 0
