"""Logical-axis sharding rules, the port's counterpart of
``repro/sharding/rules.py``.

Model code names the axes of its tensors (the spec trees of
``models.decoder`` and ``models.encdec``); a ``Rules`` table maps each
logical name to mesh axes.  ``logical_spec`` drops an axis that the mesh
lacks, that an earlier dimension took, or that does not divide the
dimension, so the same spec serves one device, a 16x16 mesh and a
2x16x16 one.  A spec is a tuple, entry for entry the reference's
``PartitionSpec``: ``None``, one axis name, or a tuple of axis names.

The mesh is an ``launch.mesh.AbstractMesh``: the port runs one process
per card (``torch.distributed``, ``launch.mesh``), so the specs feed the
dry-run's per-device shapes, memory and collectives
(``launch.steps.trace_step``), and ``shard`` annotates nothing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

# logical axis -> tuple of mesh axes (tried in order, kept if they divide)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),        # data parallel over pod+data
    "cache_batch": ("pod", "data"),  # decode KV/state cache batch dim
    "clients": ("data",),            # federated client shards (PackedClients)
    "seq": (),                       # unsharded by default
    "kv_seq": ("model",),            # decode KV cache: sequence over model axis
    "embed": (),                     # activations replicated over model (TP)
    "heads": ("model",),             # attention head parallelism
    "kv_heads": ("model",),          # GQA kv heads (dropped when not divisible)
    "head_dim": (),
    "ff": ("model",),                # column-parallel ffn
    "vocab": ("model",),             # column-parallel logits
    "experts": ("model",),           # expert parallelism
    "expert_ff": (),                 # per-expert hidden dim
    "expert_cap": (),
    "ssm_inner": ("model",),         # mamba d_inner parallelism
    "ssm_state": (),
    "fsdp": ("data",),               # parameter sharding for FSDP variants
    "none": (),
}

Spec = Tuple


class Rules:
    def __init__(self, table: Optional[Dict[str, Tuple[str, ...]]] = None,
                 fsdp: bool = False):
        self.table = dict(DEFAULT_RULES)
        if table:
            self.table.update(table)
        self.fsdp = fsdp

    def mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        return self.table.get(logical, ())


_state = threading.local()


def current_rules() -> Rules:
    r = getattr(_state, "rules", None)
    if r is None:
        r = Rules()
        _state.rules = r
    return r


@contextlib.contextmanager
def use_rules(rules: Rules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def current_mesh():
    """The ambient mesh (``launch.mesh.set_mesh``), or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (what
    ``launch.mesh.set_mesh`` returns)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def logical_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 rules: Optional[Rules] = None, mesh=None) -> Spec:
    """The spec of a tensor of ``shape`` whose dimensions are named
    ``axes``: each dimension takes its rule's mesh axes in order, skipping
    one the mesh lacks, one an earlier dimension took and one whose size
    (times the axes already taken) does not divide the dimension; trailing
    unsharded entries are dropped.  ``mesh`` defaults to the ambient one;
    with none, the empty spec (replicated)."""
    rules = rules or current_rules()
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return ()
    entries = []
    used: set = set()
    for dim, name in zip(shape, axes):
        chosen = []
        size = 1
        for ax in rules.mesh_axes(name):
            if ax in used or ax not in mesh.axis_names:
                continue
            ax_size = mesh.shape[ax]
            if dim % (size * ax_size) != 0:
                continue
            chosen.append(ax)
            size *= ax_size
        used.update(chosen)
        if not chosen:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_factor(mesh, entry) -> int:
    """How many ways one spec entry splits its dimension on ``mesh``."""
    n = 1
    for ax in spec_axes(entry):
        n *= mesh.shape[ax]
    return n


def shard(x, *axes: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names: with
    an ambient mesh the rank is checked as there, and ``x`` is returned
    as it is (one process holds one card's share; no annotation has an
    effect)."""
    if current_mesh() is not None and len(axes) != x.dim():
        raise ValueError(f"shard(): {len(axes)} axes for rank-{x.dim()} "
                         f"tensor")
    return x
