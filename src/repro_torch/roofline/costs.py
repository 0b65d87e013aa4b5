"""The op-cost counter of the port's dry-run: the counterpart of
``repro/roofline/hlo.py``.

The reference reads FLOPs, bytes and collectives from a compiled XLA
module.  The port has no XLA: it runs a step (on the meta device, or on
real tensors) under ``counting()``, a ``TorchDispatchMode`` that sees
every aten op the step dispatches, forward and backward, and charges it
the way ``hlo.py`` charges an HLO op:

- FLOPs: 2 M N K for the matmul family, one a output element for every
  other op except the zero-FLOP set (copies, casts, views, concatenation,
  padding, gathers and scatters, constants);
- bytes: the op's inputs plus its outputs, except the zero-byte set
  (views, empty buffers, ``arange``); a gather moves twice its output, a
  scatter twice its update.

The port's hand-written kernels (``kernels.ops``: flash forward and
backward, the cross-entropy forward, its pitched W and its backward, the
scan and its backward, the four federated ops) are charged as one op
each through ``kernel``: the kernel's own FLOPs and bytes, the formulas of
its bound (``roofline.analysis``), and none of the ops inside the call.
On the meta device ``kernel`` returns the kernel's outputs as empty
tensors (the plain version's shapes) without running anything.

Collectives are not dispatched by one process; ``launch.steps`` adds them
analytically (``StepCost.add_collective``), with the reference's ring
wire bytes (``collective_wire_bytes``).

The counter also tracks the bytes of live storage the step allocates: a
``weakref.finalize`` on every op output that owns new storage releases
its bytes when the tensor dies, and ``peak_bytes`` is the largest sum
seen.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch.kernels import ref
from repro_torch.roofline import analysis as A

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


@dataclasses.dataclass
class StepCost:
    """Per-device FLOPs, bytes and collective wire bytes of a step, with
    ``by_op`` ({op: [calls, flops, bytes]}), the collectives' wire bytes by
    link (``analysis.LINK_BYTES_PER_S``) and the collectives themselves
    (``roofline.debug``)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_links: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    collectives: List[tuple] = dataclasses.field(default_factory=list)

    def __add__(self, other: "StepCost") -> "StepCost":
        def merged(a, b):
            out = dict(a)
            for k, v in b.items():
                out[k] = out.get(k, 0.0) + v
            return out
        ops = {k: list(v) for k, v in self.by_op.items()}
        for k, v in other.by_op.items():
            ops[k] = [x + y for x, y in zip(ops.get(k, [0.0] * 3), v)]
        return StepCost(self.flops + other.flops,
                        self.bytes_accessed + other.bytes_accessed,
                        self.collective_bytes + other.collective_bytes,
                        merged(self.collective_breakdown,
                               other.collective_breakdown),
                        merged(self.collective_links, other.collective_links),
                        ops, self.collectives + other.collectives)

    def charge(self, name: str, flops: float, nbytes: float,
               calls: float = 1.0) -> None:
        self.flops += flops
        self.bytes_accessed += nbytes
        row = self.by_op.setdefault(name, [0.0, 0.0, 0.0])
        row[0] += calls
        row[1] += flops
        row[2] += nbytes

    def add_collective(self, kind: str, out_bytes: float, group: int,
                       link: str, label: str = "", in_bytes: float = None,
                       times: float = 1.0) -> None:
        """``times`` collectives of ``kind`` over groups of ``group``
        devices joined by ``link``, each with ``out_bytes`` of output
        (``in_bytes`` of input, a reduce-scatter's): their wire bytes, and
        their output as bytes accessed, as ``hlo.py`` counts them."""
        wire = times * collective_wire_bytes(
            kind, out_bytes, out_bytes if in_bytes is None else in_bytes,
            group)
        if not wire:
            return
        self.collective_bytes += wire
        self.bytes_accessed += times * out_bytes
        self.collective_breakdown[kind] = \
            self.collective_breakdown.get(kind, 0.0) + wire
        self.collective_links[link] = self.collective_links.get(link, 0.0) \
            + wire
        self.collectives.append((wire, kind, label, group, link, times))


def collective_wire_bytes(kind: str, out_bytes: float, in_bytes: float,
                          group: int) -> float:
    """Ring wire bytes of one collective per device, ``hlo.py``'s
    ``_collective_wire_bytes``: all-gather and all-to-all out (g-1)/g,
    all-reduce 2 out (g-1)/g, reduce-scatter in (g-1)/g, a permute its
    output; nothing in a group of one."""
    g = group
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return in_bytes * (g - 1) / g
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    if kind == "collective-permute":
        return out_bytes
    return 0.0


# ---------------------------------------------------------------------------
# the aten op rules
# ---------------------------------------------------------------------------

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot", "addmv",
           "matmul", "linear"}

#: no FLOPs (hlo.py: copy, convert, broadcast, slice, concatenate, pad,
#: gather, scatter, iota, ...)
_ZERO_FLOP = {
    "clone", "copy_", "_to_copy", "cat", "stack", "constant_pad_nd", "flip",
    "roll", "index", "index_select", "gather", "scatter", "scatter_add",
    "scatter_add_", "scatter_", "index_put", "index_put_", "embedding",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "fill_", "zero_", "new_zeros", "new_ones", "new_full", "repeat",
    "select_scatter", "slice_scatter", "expand_copy", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "arange", "lift_fresh",
    "lift_fresh_copy", "_unsafe_view", "alias", "detach", "split_with_sizes",
    "unbind", "masked_scatter", "_local_scalar_dense",
}

#: no bytes of their own (hlo.py: parameter, constant, iota, reshape, ...)
_ZERO_BYTE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "arange", "lift_fresh", "alias", "detach", "_local_scalar_dense",
    "_unsafe_view", "split_with_sizes", "unbind",
}

#: read only the rows they return: twice the output's bytes
_GATHERS = {"index", "index_select", "gather", "embedding"}
#: write only their update: twice the update's bytes (argument index)
_SCATTERS = {"scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "index_put": 2, "index_put_": 2,
             "select_scatter": 1, "slice_scatter": 1}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_cost(func, args, out):
    """(flops, bytes) of one aten op, by the rules above."""
    name = func.overloadpacket.__name__
    outs = _tensors(out)
    if name in _MATMUL:
        a = args[1] if name in ("addmm", "baddbmm", "addbmm", "addmv") \
            else args[0]
        k = a.shape[-1] if a.dim() else 1
        o = outs[0].numel()
        bias = name.startswith("add") or (name == "linear" and len(args) > 2
                                          and args[2] is not None)
        flops = 2.0 * o * k + (o if bias else 0)
        return flops, sum(_nbytes(t) for t in _tensors(args) + outs)
    if func.is_view or name in _ZERO_BYTE:
        return 0.0, 0.0
    flops = 0.0 if name in _ZERO_FLOP else float(outs[0].numel() if outs
                                                 else 0)
    if name in _GATHERS:
        return flops, 2.0 * sum(_nbytes(t) for t in outs)
    if name in _SCATTERS:
        upd = args[_SCATTERS[name]] if len(args) > _SCATTERS[name] else None
        upd = _tensors(upd)
        return flops, 2.0 * sum(_nbytes(t) for t in (upd or outs))
    return flops, float(sum(_nbytes(t) for t in _tensors(args) + outs))


class CostCounter(TorchDispatchMode):
    """The dispatch mode of ``counting()``: ``cost`` accumulates every op
    outside a ``kernel`` call; ``live_bytes`` and ``peak_bytes`` follow the
    storage the ops allocate."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self.quiet = 0
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.quiet:
            flops, nbytes = op_cost(func, args, out)
            self.cost.charge(f"aten.{func.overloadpacket.__name__}", flops,
                             nbytes)
        if not func.is_view:
            returns = func._schema.returns
            for i, t in enumerate(out if isinstance(out, (list, tuple))
                                  else (out,)):
                if (isinstance(t, torch.Tensor) and i < len(returns)
                        and returns[i].alias_info is None):
                    self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        n = t.untyped_storage().nbytes()
        if not n:
            return
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    @contextlib.contextmanager
    def quiet_block(self):
        self.quiet += 1
        try:
            yield
        finally:
            self.quiet -= 1


def active():
    """The innermost ``counting()`` counter, or None.  Read from the
    dispatch-mode stack, which torch carries into the autograd engine's
    device threads (a CUDA backward runs there), not from a Python
    thread-local, which it does not."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


@contextlib.contextmanager
def counting():
    """``with counting() as c: step()``: ``c.cost`` is the step's
    ``StepCost``, ``c.peak_bytes`` its peak of live bytes."""
    counter = CostCounter()
    with counter:
        yield counter


# ---------------------------------------------------------------------------
# the kernels: one op each
# ---------------------------------------------------------------------------


def _f32(*shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _xent_dw(h, W):
    from repro_torch.kernels.fused_xent import pitch
    d, V = W.shape
    return torch.empty((d, pitch(V)), dtype=W.dtype, device=h.device)[:, :V]


def _executed(n_iters, max_iters: int) -> int:
    """The iterations a local-SGD launch runs: the budgets' sum (a host
    read, made only while counting), all of them on the meta device."""
    if n_iters.device.type == "meta":
        return n_iters.shape[0] * max_iters
    return int(torch.clamp(n_iters, 0, max_iters).sum())


def _work(name: str, a):
    """(flops, bytes) of one call of kernel ``name`` on arguments ``a``."""
    if name == "flash_attention_fwd":
        q, k, _, causal, window = a[:5]
        B, S, Hq, hd = q.shape
        return A.flash_fwd_work(B, S, k.shape[1], Hq, k.shape[2], hd,
                                causal, window, q.element_size())
    if name == "flash_attention_bwd":
        q, k, causal, window = a[0], a[1], a[6], a[7]
        B, S, Hq, hd = q.shape
        return A.flash_bwd_work(B, S, k.shape[1], Hq, k.shape[2], hd,
                                causal, window, q.element_size())
    if name == "fused_softmax_xent_fwd":
        (T, d), V = a[0].shape, a[1].shape[1]
        return A.xent_fwd_work(T, d, V, a[0].element_size())
    if name == "fused_softmax_xent_bwd":
        (T, d), V = a[0].shape, a[1].shape[1]
        return A.xent_bwd_work(T, d, V, a[0].element_size())
    if name in ("selective_scan_fwd", "selective_scan_bwd"):
        B, S, d = a[0].shape
        work = A.scan_work if name == "selective_scan_fwd" \
            else A.scan_bwd_work
        nbytes, flops, _ = work(B, S, d, a[1].shape[1])
        return flops, nbytes
    if name == "pitched":
        W, dtype = a
        return A.pitched_work(W.shape[0], W.shape[1], W.element_size(),
                              torch.empty((), dtype=dtype).element_size())
    if name == "fed_cohort_gather":
        flat_x, max_n, K = a[0], a[4], a[2].shape[0]
        return A.gather_work(K, max_n, flat_x[0].numel(),
                             flat_x.element_size())
    if name == "fed_local_sgd_mclr":
        x, idx, w0, n_iters = a[0], a[2], a[3], a[6]
        K, max_n, feat = x.shape
        return A.mclr_sgd_work(_executed(n_iters, idx.shape[1]), K, max_n,
                               feat, w0.shape[1], idx.shape[2], idx.shape[1])
    if name == "fed_local_sgd_dense":
        x, idx, w1, w2, n_iters = a[0], a[2], a[3], a[5], a[8]
        K, max_n, feat = x.shape
        return A.dense_sgd_work(_executed(n_iters, idx.shape[1]), K, max_n,
                                feat, w1.shape[1], w2.shape[1], idx.shape[2],
                                idx.shape[1])
    if name == "fed_compress_topk_q8":
        return A.compress_work(*a[0].shape)
    raise KeyError(name)


def _meta_outputs(name: str, a):
    """A kernel's outputs as empty tensors (its plain version's shapes and
    dtypes), or None where the call itself runs on the meta device."""
    if name == "flash_attention_fwd":
        q = a[0]
        B, S, Hq, _ = q.shape
        return torch.empty_like(q), _f32(B, Hq, S, like=q)
    if name == "flash_attention_bwd":
        return tuple(torch.empty_like(t) for t in a[:3])
    if name == "fused_softmax_xent_fwd":
        T = a[0].shape[0]
        return _f32(T, like=a[0]), _f32(T, like=a[0])
    if name == "fused_softmax_xent_bwd":
        return torch.empty_like(a[0]), _xent_dw(a[0], a[1])
    if name == "selective_scan_fwd":
        B, S, d = a[0].shape
        N = a[1].shape[1]
        out = (_f32(B, S, d, like=a[0]), _f32(B, d, N, like=a[0]))
        if len(a) > 6 and a[6]:         # the checkpointing instance
            out += (_f32(B, -(-S // ref.scan_checkpoint_steps(N)), d, N,
                         like=a[0]),)
        return out
    if name == "selective_scan_bwd":
        return tuple(torch.empty_like(t) for t in a[:6])
    if name == "fed_cohort_gather":
        flat_x, flat_y, starts, _, max_n = a
        K = starts.shape[0]
        return (torch.empty((K, max_n) + tuple(flat_x.shape[1:]),
                            dtype=flat_x.dtype, device=flat_x.device),
                torch.empty((K, max_n), dtype=flat_y.dtype,
                            device=flat_y.device),
                _f32(K, max_n, like=flat_x))
    if name == "fed_local_sgd_mclr":
        K = a[0].shape[0]
        w0, b0 = a[3], a[4]
        return (_f32(K, *w0.shape, like=w0), _f32(K, *b0.shape, like=w0),
                _f32(K, like=w0))
    if name == "fed_local_sgd_dense":
        K = a[0].shape[0]
        return tuple(_f32(K, *t.shape, like=t) for t in a[3:7]) \
            + (_f32(K, like=a[3]),)
    if name == "fed_compress_topk_q8":
        ef = a[0]
        return (torch.empty(ef.shape, dtype=torch.int8, device=ef.device),
                _f32(ef.shape[0], like=ef))
    return None


def kernel(name: str, fn, *args):
    """``fn(*args)``, the wrapper of kernel ``name``, charged as one op
    (its bound's FLOPs and bytes) when a counter is active, with none of
    its inner ops counted.  On the meta device the outputs are empty
    tensors of the kernel's shapes: nothing runs, so no fallback hides
    behind it; any other device goes to ``fn``, which runs the plain
    version on a CPU tensor and launches (or raises) on a CUDA one."""
    meta = any(t.device.type == "meta" for t in _tensors(args))
    counter = active()
    if counter is None:
        if meta:
            out = _meta_outputs(name, args)
            if out is not None:
                return out
        return fn(*args)
    with counter.quiet_block():
        flops, nbytes = _work(name, args)
        out = _meta_outputs(name, args) if meta else None
        if out is None:
            out = fn(*args)
    counter.cost.charge(f"kernel.{name}", flops, nbytes)
    return out
