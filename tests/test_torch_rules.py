"""The port's logical-axis rules and spec trees (``repro_torch.sharding``,
``models.decoder`` / ``models.encdec`` / ``models.api`` specs) against the
reference's: the same spec trees, batch specs and shape configs, and
``logical_spec`` bitwise the reference's ``PartitionSpec`` for every
param, cache and batch leaf of all ten ids, on five meshes, under the
default rules and every dry-run variant's rules."""
import types

import pytest
import torch

from torch_cases import one_torch_thread  # noqa: F401

from repro.configs import (ARCH_IDS, INPUT_SHAPES, get_config as rget,
                           get_shape as rget_shape,
                           supported_shapes as rsupported)
from repro.launch import dryrun as rdry
from repro.models.api import build_model as rbuild
from repro.sharding import rules as rrules

from repro_torch.configs import (get_config, get_shape, supported_shapes)
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import AbstractMesh, set_mesh
from repro_torch.models.api import abstract_cache, abstract_params, \
    build_model
from repro_torch.sharding import rules as trules
from repro_torch.tree import tree_items

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
VARIANTS = ("baseline", "bf16", "tponly", "decode2d", "seqscan", "ssmbf16",
            "chunk128", "bf16,tponly")


def _stub(shape, names):
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


def _spec_at(specs, path):
    node = specs
    for key in path.split("/"):
        node = node[key]
    return node


def _leaves(tree, specs):
    """(path, shape, logical axes) of every leaf of a tensor tree, its axes
    padded with None to its rank as the reference's ``shardings_from_specs``
    pads them."""
    out = []
    for path, t in tree_items(tree):
        axes = list(_spec_at(specs, path))
        out.append((path, tuple(t.shape), axes + [None] * (t.dim()
                                                           - len(axes))))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_reference(arch):
    ref, port = rbuild(rget(arch)), build_model(get_config(arch))
    assert port.param_specs() == ref.param_specs()
    assert port.cache_specs() == ref.cache_specs()
    for shape_id in rsupported(rget(arch)):
        rb, raxes = ref.batch_spec(rget_shape(shape_id))
        tb, taxes = port.batch_spec(get_shape(shape_id))
        assert taxes == raxes
        assert set(tb) == set(rb)
        for k in rb:
            assert tuple(tb[k].shape) == tuple(rb[k].shape)
            assert str(tb[k].dtype).split(".")[-1] == str(rb[k].dtype)
            assert tb[k].device.type == "meta"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_spec_bitwise_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    stub, mesh = _stub(shape, names), AbstractMesh(shape, names)
    model = build_model(get_config(arch))
    trees = [(abstract_params(model), model.param_specs())]
    for shape_id in supported_shapes(model.cfg):
        s = get_shape(shape_id)
        if s.kind == "decode":
            trees.append((abstract_cache(model, s.global_batch, s.seq_len),
                          model.cache_specs()))
        else:
            trees.append(model.batch_spec(s))
    leaves = [leaf for tree, specs in trees for leaf in _leaves(tree, specs)]
    tables = set()
    for variant in VARIANTS:
        _, rr = rdry.apply_variants(rget(arch), variant)
        _, tr = tdry.apply_variants(get_config(arch), variant)
        assert tr.table == rr.table
        key = tuple(sorted(tr.table.items()))
        if key in tables:
            continue
        tables.add(key)
        for path, shp, axes in leaves:
            want = rrules.logical_spec(shp, axes, rules=rr, mesh=stub)
            got = trules.logical_spec(shp, axes, rules=tr, mesh=mesh)
            assert got == tuple(want), (variant, path, shp, axes)
            with trules.use_rules(tr), set_mesh(mesh):
                assert trules.logical_spec(shp, axes) == got
    assert len(tables) == 3      # default, tponly, decode2d


def test_logical_spec_rules_and_mesh_edge_cases():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    stub = _stub((2, 16, 16), ("pod", "data", "model"))
    cases = [((256, 4096), ("batch", None)), ((6, 4096), ("batch", None)),
             ((32, 64), ("heads", "kv_heads")), ((48, 16), ("ff", "ff")),
             ((), ()), ((7,), ("vocab",)), ((64, 64), ("none", "clients"))]
    for shp, axes in cases:
        assert trules.logical_spec(shp, axes, mesh=mesh) == tuple(
            rrules.logical_spec(shp, axes, mesh=stub))
    assert trules.logical_spec((8,), ("batch",)) == ()   # no mesh: replicated
    assert trules.DEFAULT_RULES == rrules.DEFAULT_RULES
    r = trules.Rules({"batch": ()}, fsdp=True)
    assert r.fsdp and r.mesh_axes("batch") == () and r.mesh_axes(None) == ()
    with trules.use_rules(r):
        assert trules.current_rules() is r
    assert trules.current_rules() is not r


def test_shard_checks_rank_under_a_mesh_and_returns_its_input():
    x = torch.zeros((2, 3))
    assert trules.shard(x, "batch") is x          # no mesh: no check
    with set_mesh(AbstractMesh((16, 16), ("data", "model"))):
        assert trules.shard(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="rank-2"):
            trules.shard(x, "batch")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_variants_equal_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    assert supported_shapes(cfg) == rsupported(rcfg)
    for shape_id in INPUT_SHAPES:
        s, rs = get_shape(shape_id), rget_shape(shape_id)
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            rs.name, rs.seq_len, rs.global_batch, rs.kind)
        assert tdry.variant_for(cfg, s).attention == \
            rdry.variant_for(rcfg, rs).attention
    for variant in VARIANTS:
        tc, tr = tdry.apply_variants(cfg, variant)
        rc, rr = rdry.apply_variants(rcfg, variant)
        for field in ("param_dtype", "ssm_scan", "ssm_input_dtype",
                      "ssm_chunk", "attention"):
            assert getattr(tc, field) == getattr(rc, field), (variant, field)
        assert tr.table == rr.table
    for bad in ("nope", "bf16,nope"):
        with pytest.raises(ValueError, match="unknown variant"):
            tdry.apply_variants(cfg, bad)
