"""The port's roofline tooling (``repro_torch.roofline``) against the
reference's (``repro.roofline``): the model FLOPs estimate exactly for
every (architecture, shape) pair, the ring wire bytes on synthetic
collectives, the bottleneck pick, the report's text, the op-cost
counter's FLOPs against ``analyze_hlo`` of the reference's lowered step,
and each kernel's charge against the bound formulas ``chip_smoke.py``
reported before they moved into ``roofline.analysis``."""
import json
import sys

import numpy as np
import pytest
import torch

from torch_cases import one_torch_thread  # noqa: F401

from repro.configs import ARCH_IDS, get_config as rget
from repro.configs import get_shape as rget_shape
from repro.configs import supported_shapes as rsupported
from repro.configs.base import ShapeConfig as RShape
from repro.launch.dryrun import variant_for as rvariant_for
from repro.roofline import analysis as ranalysis
from repro.roofline import hlo as rhlo
from repro.roofline import report as rreport

from repro_torch.configs import ShapeConfig, get_config, get_shape
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import variant_for
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.steps import trace_step
from repro_torch.models.api import build_model
from repro_torch.roofline import analysis as A
from repro_torch.roofline import costs
from repro_torch.roofline import report as treport

ONE = AbstractMesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_equals_reference(arch):
    for shape_id in rsupported(rget(arch)):
        want = ranalysis.model_flops_estimate(
            rvariant_for(rget(arch), rget_shape(shape_id)),
            rget_shape(shape_id))
        got = A.model_flops_estimate(
            variant_for(get_config(arch), get_shape(shape_id)),
            get_shape(shape_id))
        assert got == want, shape_id


@pytest.mark.parametrize("kind", rhlo.COLLECTIVE_OPS)
def test_collective_wire_bytes_equal_hlo(kind):
    ops_ = {"p": rhlo._Op("p", "f32[256]{0}", "parameter", "", [])}
    for group, out in ((16, "f32[1024]{0}"), (2, "bf16[64,8]{1,0}"),
                       (1, "f32[8]{0}"), (8, "f32[16]{0}")):
        op = rhlo._Op("a", out, kind,
                      f"(%p), replica_groups=[{256 // group},{group}]"
                      f"<=[256]", ["p"])
        want = rhlo._collective_wire_bytes(op, ops_, 256)
        got = costs.collective_wire_bytes(
            kind, rhlo._shape_bytes(out), rhlo._shape_bytes("f32[256]{0}"),
            group)
        assert got == pytest.approx(want), (kind, group)
    assert costs.COLLECTIVE_OPS == rhlo.COLLECTIVE_OPS


def test_roofline_terms_pick_bottleneck():
    for flops, nbytes, wire, want in ((1e15, 1e9, 0, "compute"),
                                      (1e9, 1e12, 0, "memory"),
                                      (1e9, 1e9, 1e12, "collective")):
        c = costs.StepCost(flops=flops, bytes_accessed=nbytes)
        if wire:
            c.add_collective("all-reduce", wire, 16, "network")
        rep = A.roofline_terms(c, 256, arch="x", shape="y", mesh="16x16",
                               model_flops=2e17, bytes_per_device=2 ** 30)
        assert rep.bottleneck == want
        assert rep.t_compute == flops / 989e12
        assert rep.t_memory == pytest.approx((nbytes + wire) / 3.35e12)
        assert rep.useful_ratio == 2e17 / (256 * flops)
        assert rep.row().startswith("| x | y | 16x16 |")
    # each link at its own bandwidth
    c = costs.StepCost()
    c.add_collective("all-gather", 8e9, 8, "nvlink")
    c.add_collective("all-gather", 8e9, 16, "network")
    assert A.collective_seconds(c) == pytest.approx(
        7e9 / 450e9 + 7.5e9 / 50e9)
    assert (A.HBM_BYTES_PER_S, A.BF16_FLOPS_PER_S, A.FP32_FLOPS_PER_S) == (
        3.35e12, 989e12, 67e12)
    assert A.LINK_BYTES_PER_S == {"nvlink": 450e9, "network": 50e9}


def _row(arch, shape, mesh, key, seed):
    rng = np.random.default_rng(seed)
    return {"arch": arch, "shape": shape, "mesh": mesh, "kind": "train",
            key: {"flops": float(rng.uniform(1e9, 1e15)),
                  "bytes_accessed": float(rng.uniform(1e6, 1e12)),
                  "collective_bytes": float(rng.uniform(0, 1e10)),
                  "collective_breakdown": {}},
            "roofline": {"t_compute_ms": float(rng.uniform(0, 1e3)),
                         "t_memory_ms": float(rng.uniform(0, 1e3)),
                         "t_collective_ms": float(rng.uniform(0, 1e3)),
                         "bottleneck": "memory",
                         "useful_flops_ratio": float(rng.uniform(0, 1)),
                         "bytes_per_device_gib": float(rng.uniform(0, 80))}}


@pytest.mark.parametrize("csv", [False, True])
def test_report_renders_the_reference_table(tmp_path, monkeypatch, capsys,
                                            csv):
    pairs = [("llama3.2-3b", "decode_32k", "16x16"),
             ("llama3.2-3b", "train_4k", "2x16x16"),
             ("falcon-mamba-7b", "long_500k", "16x16"),
             ("llama3.2-3b", "train_4k", "16x16")]
    for i, (arch, shape, mesh) in enumerate(pairs):
        for key, d in (("hlo", "ref"), ("trace", "port")):
            (tmp_path / d).mkdir(exist_ok=True)
            with open(tmp_path / d / f"{arch}__{shape}__{mesh}.json",
                      "w") as f:
                json.dump(_row(arch, shape, mesh, key, i), f)
    out = {}
    for d, mod in (("ref", rreport), ("port", treport)):
        argv = ["report", "--dir", str(tmp_path / d), "--mesh", "16x16"]
        monkeypatch.setattr(sys, "argv", argv + (["--csv"] if csv else []))
        mod.main()
        out[d] = capsys.readouterr().out
    assert out["port"] == out["ref"]
    assert out["port"].count("16x16") == 3
    rows = [r for r in treport.load(str(tmp_path / "port"))
            if r["mesh"] == "16x16"]
    assert treport.render(rows, csv) + "\n" == out["port"]


def test_single_matmul_flops_exact():
    a = torch.empty((128, 256), device="meta")
    b = torch.empty((256, 512), device="meta")
    with costs.counting() as c:
        a @ b
    assert c.cost.flops == 2 * 128 * 256 * 512
    assert c.cost.bytes_accessed == 4 * (128 * 256 + 256 * 512 + 128 * 512)
    assert c.peak_bytes == 4 * 128 * 512
    x = torch.empty((4, 32, 16), device="meta")
    w = torch.empty((4, 16, 8), device="meta")
    with costs.counting() as c:
        torch.bmm(x, w).sum()
    assert c.cost.by_op["aten.bmm"][1] == 2 * 4 * 32 * 16 * 8
    assert c.cost.by_op["aten.sum"][1] == 1.0      # one output element


def test_counter_op_rules_follow_hlo():
    x = torch.empty((8, 64), device="meta")
    idx = torch.empty((4,), dtype=torch.long, device="meta")
    with costs.counting() as c:
        x.view(64, 8)                       # a view: nothing
        x.to(torch.bfloat16)                # a convert: bytes, no FLOPs
        x[idx]                              # a gather: twice its output
        torch.tanh(x)                       # elementwise: one an element
    ops_ = c.cost.by_op
    assert "aten.view" not in ops_ or ops_["aten.view"][1:] == [0, 0]
    assert ops_["aten._to_copy"] == [1, 0, 8 * 64 * (4 + 2)]
    assert ops_["aten.index"][1:] == [0, 2 * 4 * 64 * 4]
    assert ops_["aten.tanh"][1:] == [8 * 64, 2 * 8 * 64 * 4]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_counter_agrees_with_analyze_hlo(kind):
    """llama3.2-3b smoke, B=2, S=256 on mesh (1, 1): the port's traced
    FLOPs against ``analyze_hlo`` of the reference's ``lower_step`` on its
    host mesh (the plain route).  Measured: port / reference = 0.937
    (train) and 0.873 (prefill).  The gap is the reference's plain
    attention: it takes the full S x T score and p v products (half of
    them masked) and the softmax over them, where the port charges its
    flash kernels for the unmasked pairs only (4 hd a pair forward, 10 hd
    backward); the port's cross-entropy backward kernel adds back the
    logits product (4 x 2 T d V against the reference's 3).  Bytes are
    not compared: the reference counts fusion boundaries, the port every
    eager op (~0.3-0.5 of the reference's here, as no S x T scores are
    stored)."""
    from repro.launch.mesh import make_host_mesh, set_mesh
    from repro.launch.steps import lower_step
    from repro.models.api import build_model as rbuild
    mesh = make_host_mesh()
    with set_mesh(mesh):
        lowered, _ = lower_step(rbuild(rget("llama3.2-3b", smoke=True)),
                                RShape("t", 256, 2, kind), mesh)
        want = rhlo.analyze_hlo(lowered.compile().as_text(), 1)
    got, _, _ = trace_step(build_model(get_config("llama3.2-3b",
                                                  smoke=True)),
                           ShapeConfig("t", 256, 2, kind), ONE)
    ratio = got.flops / want.flops
    assert 0.85 < ratio < 1.0, ratio


# the bound formulas chip_smoke.py computed inline before they moved into
# roofline.analysis (each input read once, each output written once)
def _old_flash_fwd(B, S, Hq, Hkv, hd, causal):
    pairs = B * Hq * S * (S + 1) // 2 if causal else B * Hq * S * S
    return 4 * hd * pairs, 2 * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd) \
        + 4 * B * Hq * S


def _old_flash_bwd(B, S, Hq, Hkv, hd, causal):
    pairs = B * Hq * S * (S + 1) // 2 if causal else B * Hq * S * S
    return 10 * hd * pairs, 2 * (4 * B * S * Hq * hd + 2 * B * S * Hkv * hd
                                 + 2 * B * S * Hkv * hd) + 4 * B * Hq * S


def _charge(fn, *args):
    with costs.counting() as c:
        fn(*args)
    kernels = {k: v for k, v in c.cost.by_op.items()
               if k.startswith("kernel.")}
    assert all(v[0] == 1 for v in kernels.values())
    return {k[7:]: (v[1], v[2]) for k, v in kernels.items()}, c.cost


@pytest.mark.parametrize("causal", [True, False])
def test_flash_charges_equal_the_old_bounds(causal):
    B, S, Hq, Hkv, hd = 2, 96, 6, 2, 32
    q = torch.empty((B, S, Hq, hd), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k = torch.empty((B, S, Hkv, hd), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    with costs.counting() as c:
        out = ops.flash_attention(q, k, v, causal)
        torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    got = {n[7:]: (r[1], r[2]) for n, r in c.cost.by_op.items()
           if n.startswith("kernel.")}
    assert got == {"flash_attention_fwd": _old_flash_fwd(B, S, Hq, Hkv, hd,
                                                         causal),
                   "flash_attention_bwd": _old_flash_bwd(B, S, Hq, Hkv, hd,
                                                         causal)}
    # a window: the pairs a sliding window leaves, counted exactly
    W = 17
    pairs = sum(min(i + 1, W) for i in range(S))
    assert A.attention_pairs(S, S, True, W) == pairs
    assert A.attention_pairs(S, S, True) == S * (S + 1) // 2
    assert A.attention_pairs(S, S, False) == S * S


def test_xent_charges_equal_the_old_bounds():
    T, d, V = 64, 32, 1003
    h = torch.empty((T, d), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    W0 = torch.empty((d, V), dtype=torch.float32, device="meta",
                     requires_grad=True)
    labels = torch.empty((T,), dtype=torch.int32, device="meta")
    with costs.counting() as c:
        W = ops.pitched(W0, torch.bfloat16)
        loss = ops.fused_softmax_xent(h, W, labels)
        torch.autograd.grad(loss.sum(), (h, W0))
    got = {n[7:]: (r[1], r[2]) for n, r in c.cost.by_op.items()
           if n.startswith("kernel.")}
    flops = 2 * T * d * V
    assert got["fused_softmax_xent_fwd"] == (
        flops, 2 * (T * d + d * V) + 4 * T + 4 * T)
    assert got["fused_softmax_xent_bwd"] == (
        3 * flops, 4 * (T * d + d * V) + 12 * T)
    assert got["pitched"] == (0, d * V * 4 + d * 1008 * 2)


def test_scan_and_fl_charges_equal_the_old_bounds():
    B, S, d, N = 2, 16, 64, 8
    f32 = dict(dtype=torch.float32, device="meta")
    args = (torch.empty((B, S, d), **f32), torch.empty((d, N), **f32),
            torch.empty((B, S, N), **f32), torch.empty((B, S, N), **f32),
            torch.empty((B, S, d), **f32), torch.empty((B, d, N), **f32))
    got, _ = _charge(ops.selective_scan, *args)
    assert got["selective_scan_fwd"] == (
        6 * B * S * d * N,
        4 * (3 * B * S * d + 2 * B * S * N + d * N + 2 * B * d * N))
    assert A.scan_work(B, S, d, N)[2] == B * S * d * N

    rng = np.random.default_rng(0)
    K, max_n, feat, C, Bm, max_iters, H = 4, 24, 16, 5, 4, 12, 8
    flat = torch.from_numpy(rng.normal(size=(3 * max_n, feat)).astype(
        np.float32))
    flat_y = torch.zeros(3 * max_n, dtype=torch.int32)
    starts = torch.tensor([0, 5, 20, 40], dtype=torch.int32)
    ns = torch.tensor([24, 3, 0, 17], dtype=torch.int32)
    got, _ = _charge(ops.fed_cohort_gather, flat, flat_y, starts, ns, max_n)
    assert got["fed_cohort_gather"] == (
        0, 2 * K * max_n * feat * 4 + 3 * K * max_n * 4 + 2 * K * 4)
    x, y, _ = ops.fed_cohort_gather(flat, flat_y, starts, ns, max_n)
    idx = torch.zeros((K, max_iters, Bm), dtype=torch.int32)
    n_iters = torch.tensor([12, 7, 0, 5], dtype=torch.int32)
    w0, b0 = torch.zeros((feat, C)), torch.zeros(C)
    got, _ = _charge(ops.fed_local_sgd_mclr, x, y, idx, w0, b0, ns, n_iters,
                     0.1)
    executed = 24
    assert got["fed_local_sgd_mclr"] == (
        executed * (4 * Bm * feat * C + 2 * feat * C + 8 * Bm * C),
        x.numel() * 4 + y.numel() * 4 + idx.numel() * 4
        + (w0.numel() + b0.numel()) * 4 + 2 * K * 4
        + K * (feat * C + C + 1) * 4)
    w1, b1, w2, b2 = (torch.zeros((feat, H)), torch.zeros(H),
                      torch.zeros((H, C)), torch.zeros(C))
    got, _ = _charge(ops.fed_local_sgd_dense, x, y, idx, w1, b1, w2, b2, ns,
                     n_iters, 0.1)
    d_params = feat * H + H + H * C + C
    assert got["fed_local_sgd_dense"] == (
        executed * (4 * Bm * feat * H + 6 * Bm * H * C),
        x.numel() * 4 + y.numel() * 4 + idx.numel() * 4 + d_params * 4
        + 2 * K * 4 + K * (d_params + 1) * 4)
    ef = torch.from_numpy(rng.normal(size=(K, 300)).astype(np.float32))
    got, _ = _charge(ops.fed_compress_topk_q8, ef, 30)
    assert got["fed_compress_topk_q8"] == (0, K * 300 * 5 + 4 * K)
    # on the meta device every budget counts
    got, _ = _charge(ops.fed_local_sgd_mclr, *(t.to("meta") for t in (
        x, y, idx, w0, b0, ns, n_iters)), 0.1)
    assert got["fed_local_sgd_mclr"][0] == K * max_iters * (
        4 * Bm * feat * C + 2 * feat * C + 8 * Bm * C)


def test_kernel_calls_without_a_counter_are_the_plain_calls():
    """Outside ``counting()`` a CPU call is the wrapper's own (bitwise),
    and a meta call makes the kernel's output shapes."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(
        np.float32)) for _ in range(3))
    from repro_torch.kernels import flash_attention as fa
    want = fa.flash_attention_fwd(q, k, v, True, 0)
    got = costs.kernel("flash_attention_fwd", fa.flash_attention_fwd, q, k,
                       v, True, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out, lse = costs.kernel("flash_attention_fwd", fa.flash_attention_fwd,
                            q.to("meta"), k.to("meta"), v.to("meta"), True,
                            0)
    assert out.device.type == "meta" and lse.shape == (1, 2, 8)
    assert costs.active() is None
