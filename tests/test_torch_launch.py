"""The port's dry-run launch layer (``launch.mesh``'s abstract meshes,
``launch.steps``' shardings and step trace, ``models.api``'s abstract
params and caches) against the reference's: the meta-device params and
caches have the shapes and dtypes of the reference's ``jax.eval_shape``
for all ten ids, shard shapes follow the specs, and a traced step's
memory counts its arguments exactly."""
import math

import jax
import pytest
import torch

from torch_cases import DRYRUN_CASES, one_torch_thread  # noqa: F401

from repro.configs import ARCH_IDS, get_config as rget
from repro.launch.steps import make_optimizer as rmake_optimizer
from repro.launch.steps import opt_state_specs as ropt_state_specs
from repro.models import api as rapi

from repro_torch.configs import ShapeConfig, get_config, get_shape
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.tree import tree_items, tree_leaves

ONE = tmesh.AbstractMesh((1, 1), ("data", "model"))


def _shapes(tree):
    return {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in tree_items(tree)}


def _jax_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(x.shape), str(x.dtype)) for path, x in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_cache_match_eval_shape(arch):
    ref = rapi.build_model(rget(arch))
    port = tapi.build_model(get_config(arch))
    params = tapi.abstract_params(port)
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    assert _shapes(params) == _jax_shapes(rapi.abstract_params(ref))
    cache = tapi.abstract_cache(port, 4, 512)
    assert all(t.device.type == "meta" for t in tree_leaves(cache))
    assert _shapes(cache) == _jax_shapes(rapi.abstract_cache(ref, 4, 512))


def test_meshes_and_links():
    m = tmesh.make_production_mesh()
    assert (m.axis_names, m.shape, m.devices.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    mp = tmesh.make_production_mesh(multi_pod=True)
    assert (mp.axis_names, mp.devices.size) == (("pod", "data", "model"),
                                               512)
    assert mp.name == "2x16x16" and m.name == "16x16"
    host = tmesh.make_host_mesh()
    assert host.axis_names == ("data", "model") and host.shape["model"] == 1
    assert host.devices.size == max(1, torch.cuda.device_count())
    # a 16-device model axis spans two 8-GPU nodes; 8 data rows of one
    # model column sit in one node only when the model axis is 1
    assert m.link(("model",)) == "network" and m.link(("data",)) == \
        "network"
    m81 = tmesh.AbstractMesh((8, 1), ("data", "model"))
    assert m81.link(("data",)) == "nvlink"
    m42 = tmesh.AbstractMesh((4, 2), ("data", "model"))
    assert m42.link(("data", "model")) == "nvlink"
    with pytest.raises(ValueError):
        tmesh.AbstractMesh((2, 2), ("data",))
    from repro_torch.sharding.rules import current_mesh
    with tmesh.set_mesh(m):
        assert current_mesh() is m
    assert current_mesh() is None


def test_shardings_from_specs_structure_and_shard_shapes():
    mesh = tmesh.make_production_mesh()
    shapes = {"a": torch.empty((32, 48), device="meta"),
              "b": {"c": torch.empty((4,), device="meta")},
              "d": torch.empty((3, 5), device="meta")}
    specs = {"a": ("batch", "ff"), "b": {"c": ("embed",)}}
    sh = tsteps.shardings_from_specs(mesh, shapes, specs)
    assert sh["a"] == tsteps.Sharding(("data", "model"), (2, 3))
    assert sh["b"]["c"] == tsteps.Sharding((), (4,))
    assert sh["d"] == tsteps.Sharding((), (3, 5))     # no spec: replicated
    assert tsteps.replicated(mesh, shapes)["a"].shard_shape == (32, 48)
    assert tsteps.sharded_bytes(mesh, shapes, specs) == 4 * (6 + 4 + 15)


def test_opt_state_specs_match_reference_and_structure():
    cfg = get_config("llama3.2-3b", smoke=True)
    model = tapi.build_model(cfg)
    aparams = tapi.abstract_params(model)
    for name in ("sgd", "adamw"):
        assert tsteps.opt_state_specs(name, model.param_specs()) == \
            ropt_state_specs(name, model.param_specs())
        state = tsteps.make_optimizer(name).init(aparams)
        sh = tsteps.shardings_from_specs(
            ONE, state, tsteps.opt_state_specs(name, model.param_specs()))
        assert [p for p, _ in tree_items(sh)] == \
            [p for p, _ in tree_items(state)]
        rstate = jax.eval_shape(rmake_optimizer(name).init,
                                rapi.abstract_params(rapi.build_model(
                                    rget("llama3.2-3b", smoke=True))))
        assert _shapes(state) == _jax_shapes(rstate)
    with pytest.raises(ValueError):
        tsteps.opt_state_specs("lion", {})


def test_device_share_widths():
    """One device's widths on 16x16: split where the rules' axes divide,
    whole where they do not; a decode over a split cache keeps every
    head; an MoE keeps the global capacity."""
    mesh = tmesh.make_production_mesh()
    from repro_torch.models.moe import moe_capacity
    llama = get_config("llama3.2-3b")          # 24 heads / 8 kv: whole
    s = tsteps.device_share(llama, mesh)
    assert (s.n_heads, s.n_kv_heads, s.d_ff, s.vocab_size) == (24, 8, 512,
                                                               128256 // 16)
    mistral = get_config("mistral-large-123b")  # 96 heads: 6 a device
    s = tsteps.device_share(mistral, mesh)
    assert (s.n_heads, s.n_kv_heads, s.resolved_head_dim) == (
        6, 1, mistral.resolved_head_dim)
    assert tsteps.device_share(mistral, mesh,
                               get_shape("decode_32k")).n_heads == 96
    kimi = get_config("kimi-k2-1t-a32b")
    s = tsteps.device_share(kimi, mesh)
    assert (s.n_experts, s.experts_per_token) == (24, 8)
    granite = get_config("granite-moe-1b-a400m")
    s = tsteps.device_share(granite, mesh)
    assert (s.n_experts, s.experts_per_token) == (2, 2)
    for S in (1, 4096, 32768):
        assert moe_capacity(s, S) == moe_capacity(granite, S)
    falcon = get_config("falcon-mamba-7b")
    assert tsteps.device_share(falcon, mesh).d_inner == falcon.d_inner // 16
    assert tsteps.device_share(llama, ONE) .n_heads == 24


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_trace_step_memory_counts_arguments(kind):
    model = tapi.build_model(get_config("llama3.2-3b", smoke=True))
    shape = ShapeConfig("t", 64, 4, kind)
    mesh = tmesh.AbstractMesh((4, 2), ("data", "model"))
    cost, k, mem = tsteps.trace_step(model, shape, mesh, "adamw")
    assert k == kind and cost.flops > 0 and cost.bytes_accessed > 0
    params = tapi.abstract_params(model)
    full = sum(t.numel() * 4 for t in tree_leaves(params))
    assert 0 < mem["params_bytes"] < full
    assert mem["optimizer_bytes"] == (
        2 * mem["params_bytes"] + 4 if kind == "train" else 0)
    assert (mem["cache_bytes"] > 0) == (kind == "decode")
    assert mem["argument_bytes"] == sum(
        mem[k] for k in ("params_bytes", "optimizer_bytes", "batch_bytes",
                         "cache_bytes"))
    assert mem["temp_bytes"] > 0
    one = tsteps.step_memory(model, shape, ONE, "adamw")
    assert one["params_bytes"] == full


def _f32(arch):
    """The smoke config in float32: the cross-entropy backward then takes
    the plain recompute on every device (the meta device follows the
    card's route, which a bfloat16 CPU tensor does not take)."""
    return tapi.build_model(get_config(arch, smoke=True).replace(
        dtype="float32"))


def _costly(cost):
    """``by_op`` without the ops that cost nothing (views, empty
    buffers), which a layout difference adds or removes."""
    return {k: v for k, v in cost.by_op.items() if v[1] or v[2]}


@pytest.mark.parametrize("arch,kind,S,B", DRYRUN_CASES)
def test_trace_step_on_the_cpu_equals_meta(arch, kind, S, B):
    """The same step traced on CPU tensors (the plain versions run, their
    inner ops uncounted, a Mamba train step's plain scan backward too)
    and on the meta device (each kernel charged at its bound, the scan's
    backward as one ``selective_scan_bwd``) charges the same FLOPs, and
    the same bytes op by op.  The one
    exception: the plain flash backward's dq/dk/dv come in another
    layout than the kernel's (which the meta device models), so a train
    step with attention copies some of them on the CPU: 0.1% of the
    Llama smoke step's bytes, 2.1% of the whisper-tiny smoke step's."""
    model = _f32(arch)
    shape = ShapeConfig("t", S, B, kind)
    meta, _, _ = tsteps.trace_step(model, shape, ONE)
    cpu, _, _ = tsteps.trace_step(model, shape, ONE, device="cpu")
    assert cpu.flops == meta.flops
    if kind == "train" and model.cfg.n_heads:
        rest = lambda c: {k: v for k, v in _costly(c).items()  # noqa
                          if k != "aten.clone"}
        extra = _costly(cpu)["aten.clone"][2] - _costly(meta).get(
            "aten.clone", [0.0] * 3)[2]
        assert 0 < extra < 3e-2 * cpu.bytes_accessed
        assert cpu.bytes_accessed - meta.bytes_accessed == extra
        assert rest(cpu) == rest(meta)
    else:
        assert cpu.bytes_accessed == meta.bytes_accessed
        assert _costly(cpu) == _costly(meta)


def test_trace_step_collectives_on_production_mesh():
    """16x16: llama's FSDP gathers cross the network, its gradients are
    reduce-scattered over data, its FFN and vocab residuals all-reduced
    over model; on 1x1 there are none."""
    model = tapi.build_model(get_config("llama3.2-3b", smoke=True))
    shape = get_shape("train_4k")
    mesh = tmesh.make_production_mesh()
    small = ShapeConfig("train_4k", 64, shape.global_batch, "train")
    cost, _, mem = tsteps.trace_step(model, small, mesh)
    assert set(cost.collective_breakdown) == {"all-gather",
                                              "reduce-scatter", "all-reduce"}
    assert set(cost.collective_links) == {"network"}
    assert cost.collective_bytes == pytest.approx(
        sum(c[0] for c in cost.collectives))
    one, _, _ = tsteps.trace_step(model, ShapeConfig("t", 64, 2, "train"),
                                  ONE)
    assert one.collective_bytes == 0 and not one.collectives
    assert math.isclose(sum(cost.collective_breakdown.values()),
                        cost.collective_bytes)
