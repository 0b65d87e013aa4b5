"""Step builders of the port: train, prefill and decode steps over a
``models.api.Model``, the counterparts of ``repro/launch/steps.py``, and
the dry-run's step trace.

The reference lowers a step on its production mesh with XLA shardings
from the logical-axis specs and reads the partitioned module.  The port
has no XLA: ``shardings_from_specs`` gives each leaf its spec and its
per-device shard shape, and ``trace_step`` (the counterpart of
``lower_step``) runs one device's share of the step on the meta device
under the op-cost counter (``roofline.costs``), then adds the step's
collectives analytically from the same specs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.optim import adamw, sgd
from repro_torch.sharding.rules import (logical_spec, shard_factor,
                                        spec_axes)
from repro_torch.tree import tree_items, tree_leaves, tree_map


def make_optimizer(name: str, lr: float = 1e-4):
    if name == "sgd":
        return sgd(lr)
    if name == "adamw":
        return adamw(lr)
    raise ValueError(name)


def _restack(tree):
    """A gradient tree over ``leaf_views`` back in the params' layout: each
    list of per-layer gradients stacked into one [G, ...] tensor."""
    if isinstance(tree, dict):
        return {k: _restack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return torch.stack(tree)
    return tree


def make_train_step(model, optimizer):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss).

    The gradient of ``model.train_loss`` is taken over the model's
    ``leaf_views`` (one autograd leaf per layer), then restacked, and the
    optimizer's update returns new params and state.  A leaf the loss does
    not read gets a zero gradient, as under ``jax.value_and_grad``."""
    views = getattr(model, "leaf_views", None) or (lambda p: p)

    def train_step(params, opt_state, batch):
        tree = views(tree_map(torch.Tensor.detach, params))
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.train_loss(tree, batch)
        grads = iter(torch.autograd.grad(loss, leaves,
                                         materialize_grads=True))
        for p in leaves:
            p.requires_grad_(False)
        gtree = _restack(tree_map(lambda _: next(grads), tree))
        with torch.no_grad():
            params, opt_state = optimizer.update(gtree, opt_state, params)
        return params, opt_state, loss.detach()
    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, tokens, cur_index):
        with torch.inference_mode():
            return model.decode_step(params, cache, tokens, cur_index)
    return decode_step


# ---------------------------------------------------------------------------
# shardings from the logical-axis specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's spec on a mesh and the shape of one device's shard."""
    spec: Tuple
    shard_shape: Tuple[int, ...]


def _is_spec_leaf(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in s)


def _spec_at(specs, path):
    """The spec tuple at ``path`` (keys) of a spec tree, or None."""
    node = specs
    for key in path:
        if _is_spec_leaf(node) or not isinstance(node, dict) \
                or key not in node:
            return None
        node = node[key]
    return node if _is_spec_leaf(node) else None


def _shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    return tuple(d // shard_factor(mesh, spec[i]) if i < len(spec) else d
                 for i, d in enumerate(shape))


def shardings_from_specs(mesh, shapes_tree, specs_tree):
    """A ``Sharding`` a leaf of ``shapes_tree`` (tensors, or anything with
    a ``.shape``): ``logical_spec`` of the leaf's axes in ``specs_tree``
    (the empty spec for a leaf without one) on ``mesh``."""
    def one(path, leaf):
        axes = _spec_at(specs_tree, path.split("/") if path else [])
        shape = tuple(leaf.shape)
        if axes is None:
            spec = ()
        else:
            spec = logical_spec(shape, list(axes) + [None] * (
                len(shape) - len(axes)), mesh=mesh)
        return Sharding(spec, _shard_shape(shape, spec, mesh))
    items = tree_items(shapes_tree)
    it = iter(one(p, leaf) for p, leaf in items)
    return tree_map(lambda _: next(it), shapes_tree)


def replicated(mesh, tree):
    """Every leaf whole on every device of ``mesh``."""
    return tree_map(lambda x: Sharding((), tuple(x.shape)), tree)


def opt_state_specs(opt_name: str, param_specs_tree):
    """Spec tree matching the optimizer state structure."""
    if opt_name == "sgd":
        return {"step": ("none",)}
    if opt_name == "adamw":
        return {"m": param_specs_tree, "v": param_specs_tree,
                "step": ("none",)}
    raise ValueError(opt_name)


def sharded_bytes(mesh, shapes_tree, specs_tree) -> int:
    """Bytes of one device's shards of every leaf of ``shapes_tree``."""
    total = 0
    for leaf, sh in zip(tree_leaves(shapes_tree), tree_leaves(
            shardings_from_specs(mesh, shapes_tree, specs_tree))):
        total += math.prod(sh.shard_shape) * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# one device's share of a step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceShare(ArchConfig):
    """An ``ArchConfig`` at one device's widths: ``inner`` replaces the
    Mamba ``d_inner`` (``ssm_expand * d_model``) when a mesh splits it."""
    inner: int = 0

    @property
    def d_inner(self) -> int:
        return self.inner or self.ssm_expand * self.d_model


def _factor(mesh, axis: str, dim: int) -> int:
    """How many ways ``logical_spec`` splits a dimension of size ``dim``
    named ``axis`` on ``mesh`` (under the current rules)."""
    if dim <= 0:
        return 1
    spec = logical_spec((dim,), (axis,), mesh=mesh)
    return shard_factor(mesh, spec[0]) if spec else 1


def _kv_heads(hq: int, hq_local: int, hkv: int, hkv_local: int) -> int:
    """The kv heads one device's ``hq_local`` query heads read: its shard
    of them when that divides its query heads, else the smallest divisor
    of ``hq_local`` covering the groups of its query heads."""
    if hkv_local and hq_local % hkv_local == 0:
        return hkv_local
    need = -(-hq_local * hkv // hq)
    return min(n for n in range(need, hq_local + 1) if hq_local % n == 0)


def _seq_split(mesh, shape) -> Tuple[str, ...]:
    """The mesh axes that split a decode step's cache sequence (its
    ``seq_len`` slots), or () for any other step."""
    if shape is None or shape.kind != "decode":
        return ()
    return _axes(mesh, "kv_seq", shape.seq_len)


def device_share(cfg: ArchConfig, mesh, shape=None) -> DeviceShare:
    """``cfg`` at one device's widths on ``mesh`` for a step of ``shape``
    (a ``ShapeConfig``; None for a train or prefill step): the heads, kv
    heads, FFN width, vocabulary, experts and Mamba inner width divided by
    the ways the current rules split them (a width they leave whole stays
    whole, so replicated work is counted on every device).  A decode step
    whose cache sequence is split over the mesh keeps every head: each
    device attends over its slots with all of them."""
    kw = {}
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq and not _seq_split(mesh, shape):
        hq_l = hq // _factor(mesh, "heads", hq)
        kw.update(head_dim=cfg.resolved_head_dim, n_heads=hq_l,
                  n_kv_heads=_kv_heads(
            hq, hq_l, hkv, hkv // _factor(mesh, "kv_heads", hkv)))
    if cfg.d_ff > 0:
        kw["d_ff"] = cfg.d_ff // _factor(mesh, "ff", cfg.d_ff)
    kw["vocab_size"] = cfg.vocab_size // _factor(mesh, "vocab",
                                                 cfg.vocab_size)
    if cfg.n_experts:
        E = cfg.n_experts // _factor(mesh, "experts", cfg.n_experts)
        k = min(cfg.experts_per_token, E)
        # the capacity ceil(S k / E cf) of every call stays the global one
        kw.update(n_experts=E, experts_per_token=k,
                  capacity_factor=cfg.capacity_factor
                  * cfg.experts_per_token * E / (cfg.n_experts * k))
    if cfg.ssm_state:
        kw["inner"] = cfg.d_inner // _factor(mesh, "ssm_inner", cfg.d_inner)
    base = {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(ArchConfig)}
    return DeviceShare(**{**base, **kw})


def _on(device, tree):
    """A meta tree as zeros on ``device`` (itself on the meta device)."""
    if torch.device(device).type == "meta":
        return tree
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device), tree)


def _resized(tree, specs, dims):
    """``tree`` with each leaf's dimension named by a key of ``dims`` (in
    the leaf's spec) resized by ``dims[name](global size)``."""
    def fix(path, leaf):
        axes = _spec_at(specs, path.split("/")) or ()
        shape = list(leaf.shape)
        for i, name in enumerate(axes):
            if name in dims:
                shape[i] = dims[name](shape[i])
        if shape == list(leaf.shape):
            return leaf
        return torch.empty(shape, dtype=leaf.dtype, device=leaf.device)
    items = iter(fix(p, x) for p, x in tree_items(tree))
    return tree_map(lambda _: next(items), tree)


def _local_inputs(model, share_model, shape, mesh, optimizer_name, device):
    """One device's (params, optimizer state or None, batch, cache or
    None, batch rows) on ``device``: the share's params (the MoE experts'
    hidden width split as ``expert_ff`` is), its batch rows, and in
    decode its cache with the sequence split as ``kv_seq`` is."""
    from repro_torch.models.api import abstract_cache, abstract_params
    cfg, kind = model.cfg, shape.kind
    B = shape.global_batch
    Bl = B // _factor(mesh, "cache_batch" if kind == "decode" else "batch",
                      B)
    params = abstract_params(share_model)
    if cfg.n_experts:
        eff = _factor(mesh, "expert_ff", cfg.d_ff)
        params = _resized(params, share_model.param_specs(),
                          {"expert_ff": lambda _: cfg.d_ff // eff})
    params = _on(device, params)
    state = cache = None
    if kind == "train":
        state = make_optimizer(optimizer_name).init(params)
    if kind == "decode":
        cache = _resized(abstract_cache(share_model, Bl, shape.seq_len),
                         share_model.cache_specs(),
                         {"kv_seq": lambda n: n // _factor(mesh, "kv_seq",
                                                           n)})
        batch = {"tokens": torch.empty((Bl, 1), dtype=torch.int32,
                                       device="meta")}
        cache = _on(device, cache)
    else:
        batch, _ = share_model.batch_spec(ShapeConfig(
            shape.name, shape.seq_len, Bl, kind))
    return params, state, _on(device, batch), cache, Bl


def step_memory(model, shape, mesh, optimizer_name: str = "sgd") -> dict:
    """Bytes of one device's arguments, exactly from the specs: its
    shards of the params, the optimizer state (a train step), the batch
    and the decode cache and tokens."""
    from repro_torch.models.api import abstract_cache, abstract_params
    params = abstract_params(model)
    pspecs = model.param_specs()
    mem = {"params_bytes": sharded_bytes(mesh, params, pspecs),
           "optimizer_bytes": 0, "batch_bytes": 0, "cache_bytes": 0}
    if shape.kind == "train":
        mem["optimizer_bytes"] = sharded_bytes(
            mesh, make_optimizer(optimizer_name).init(params),
            opt_state_specs(optimizer_name, pspecs))
    if shape.kind == "decode":
        B = shape.global_batch
        mem["cache_bytes"] = sharded_bytes(
            mesh, abstract_cache(model, B, shape.seq_len),
            model.cache_specs())
        mem["batch_bytes"] = sharded_bytes(
            mesh, {"t": torch.empty((B, 1), dtype=torch.int32,
                                    device="meta")}, {"t": ("batch", None)})
    else:
        batch, axes = model.batch_spec(shape)
        mem["batch_bytes"] = sharded_bytes(mesh, batch, axes)
    mem["argument_bytes"] = sum(mem.values())
    return mem


def _axes(mesh, axis: str, dim: int) -> Tuple[str, ...]:
    spec = logical_spec((dim,), (axis,), mesh=mesh)
    return spec_axes(spec[0]) if spec else ()


def _group(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def add_collectives(cost, model, shape, mesh, rows: int) -> None:
    """The step's collectives on ``mesh``, per device, into ``cost``:

    - an all-gather of each parameter whose ``fsdp`` dimension the mesh
      splits, once a pass over the layers (a train step's forward, its
      backward and, under remat, its recompute);
    - a train step's gradient sync over the batch's data axes: a
      reduce-scatter over the axes that shard the parameter's ``fsdp``
      dimension, an all-reduce over the others;
    - an all-reduce of the [rows, d] residual after each attention,
      Mamba mixer, FFN and MoE layer that the mesh splits (its heads,
      inner width, FFN width, experts), once a pass; after a split
      vocabulary, the two [rows] float32 softmax statistics of the loss
      (train) or an all-gather of the logits (prefill, decode);
    - in decode, the combine of each attention's partial outputs and
      softmax statistics over a cache sequence that the mesh splits.

    ``rows`` is one device's batch rows; each collective takes its axes'
    link (``AbstractMesh.link``)."""
    from repro_torch.models.api import abstract_params
    from repro_torch.models.decoder import block_kinds
    cfg, kind = model.cfg, shape.kind
    # the encoder-decoder recomputes nothing in its backward (encdec.py)
    remat = cfg.remat and not cfg.is_encoder_decoder
    passes = 1 if kind != "train" else (3 if remat else 2)
    act = torch.empty((), dtype=cfg.compute_dtype).element_size()
    d = cfg.d_model
    batch_axes = _axes(mesh, "batch", shape.global_batch)

    params = abstract_params(model)
    specs = model.param_specs()
    for path, leaf in tree_items(params):
        axes = _spec_at(specs, path.split("/")) or ()
        shape_ = tuple(leaf.shape)
        spec = logical_spec(shape_, list(axes) + [None] * (
            len(shape_) - len(axes)), mesh=mesh)
        gathered = list(_shard_shape(shape_, spec, mesh))
        fs = ()
        for i, name in enumerate(axes[:len(spec)]):
            if name == "fsdp" and spec[i] is not None:
                gathered[i] = shape_[i]
                fs += spec_axes(spec[i])
        nbytes = math.prod(gathered) * leaf.element_size()
        if fs:
            cost.add_collective("all-gather", nbytes, _group(mesh, fs),
                                mesh.link(fs), f"fsdp {path}", times=passes)
        if kind != "train":
            continue
        held = {a for e in spec for a in spec_axes(e)} - set(fs)
        dp = [a for a in batch_axes if a not in held]
        rs = tuple(a for a in dp if a in fs)
        ar = tuple(a for a in dp if a not in fs)
        if rs:
            g = _group(mesh, rs)
            cost.add_collective("reduce-scatter", nbytes / g, g,
                                mesh.link(rs), f"grad {path}",
                                in_bytes=nbytes)
            nbytes /= g
        if ar:
            cost.add_collective("all-reduce", nbytes, _group(mesh, ar),
                                mesh.link(ar), f"grad {path}")

    def residual(axes, n_rows, label, times):
        if axes:
            cost.add_collective("all-reduce", n_rows * d * act,
                                _group(mesh, axes), mesh.link(axes), label,
                                times=times * passes)

    decode = kind == "decode"
    S = 1 if decode else shape.seq_len
    seq_axes = _seq_split(mesh, shape)
    hq = cfg.n_heads
    hd = cfg.resolved_head_dim if hq else 0
    heads = () if seq_axes or not hq else _axes(mesh, "heads", hq)

    def combine(n_layers, label):
        if seq_axes:
            cost.add_collective("all-reduce", rows * hq * (hd + 2) * 4,
                                _group(mesh, seq_axes), mesh.link(seq_axes),
                                label, times=n_layers)

    ff = _axes(mesh, "ff", cfg.d_ff) if cfg.d_ff > 0 else ()
    if cfg.is_encoder_decoder:
        T = 1 if decode else min(cfg.max_decoder_len, shape.seq_len)
        if not decode:
            residual(heads, rows * S, "encoder attention",
                     cfg.n_encoder_layers)
            residual(ff, rows * S, "encoder ffn", cfg.n_encoder_layers)
        residual(heads, rows * T, "decoder attention", 2 * cfg.n_layers)
        residual(ff, rows * T, "decoder ffn", cfg.n_layers)
        combine(2 * cfg.n_layers, "decode attention combine")
        S = T
    else:
        period = cfg.attn_period or 1
        G = cfg.n_layers // period
        moe = (_axes(mesh, "experts", cfg.n_experts)
               + _axes(mesh, "expert_ff", cfg.d_ff)) if cfg.n_experts else ()
        inner = _axes(mesh, "ssm_inner", cfg.d_inner) if cfg.ssm_state \
            else ()
        for p in range(period):
            mixer, ffn = block_kinds(cfg, p)
            if mixer == "attn":
                residual(heads, rows * S, "attention", G)
                combine(G, "decode attention combine")
            else:
                residual(inner, rows * S, "mamba", G)
            if ffn == "dense":
                residual(ff, rows * S, "ffn", G)
            elif ffn == "moe":
                residual(moe, rows * S, "moe combine", G)
    vocab = _axes(mesh, "vocab", cfg.vocab_size)
    if vocab:
        g, link = _group(mesh, vocab), mesh.link(vocab)
        if kind == "train":
            cost.add_collective("all-reduce", 2 * rows * S * 4, g, link,
                                "vocab softmax statistics", times=passes)
        else:
            cost.add_collective("all-gather", rows * cfg.vocab_size * act,
                                g, link, "vocab logits")


def trace_step(model, shape: ShapeConfig, mesh, optimizer_name: str = "sgd",
               device: Any = "meta"):
    """The counterpart of the reference's ``lower_step``: one device's
    share of the right step for (model, shape) on ``mesh`` (``device_share``
    and its batch rows, under the current rules), run under the op-cost
    counter, plus the step's collectives (``add_collectives``).  Returns
    (``roofline.costs.StepCost``, kind, memory): ``memory`` holds the
    arguments' bytes from the specs (``step_memory``) and ``temp_bytes``,
    the peak of the live bytes the trace allocated beyond them.  On the
    meta device nothing is allocated; on another device the arguments are
    zeros there and the kernels run."""
    from repro_torch.models.api import build_model
    from repro_torch.roofline import costs
    kind = shape.kind
    share_model = build_model(device_share(model.cfg, mesh, shape))
    params, state, batch, cache, rows = _local_inputs(
        model, share_model, shape, mesh, optimizer_name, device)
    with costs.counting() as counter:
        if kind == "train":
            make_train_step(share_model, make_optimizer(optimizer_name))(
                params, state, batch)
        else:
            # no_grad, not the serving steps' inference_mode: under
            # inference_mode torch dispatches einsum, matmul and the other
            # composite ops whole, where a gradient-enabled step (and
            # no_grad) dispatches the aten ops they are made of
            with torch.no_grad():
                if kind == "prefill":
                    share_model.prefill(params, batch)
                else:
                    share_model.decode_step(params, cache, batch["tokens"],
                                            shape.seq_len - 1)
    cost = counter.cost
    add_collectives(cost, model, shape, mesh, rows)
    memory = step_memory(model, shape, mesh, optimizer_name)
    memory["temp_bytes"] = counter.peak_bytes
    return cost, kind, memory
