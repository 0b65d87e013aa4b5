"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's layout: ``run_one``'s JSON has the reference's keys with
``trace`` for ``hlo``, ``memory`` for ``memory_analysis`` and ``trace_s``
for ``lower_s``/``compile_s``; the pairs are the reference's; kimi-k2's
params stay on the meta device."""
import json
import os

import pytest

from torch_cases import one_torch_thread  # noqa: F401

from repro.launch import dryrun as rdry

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as tdry
from repro_torch.models.api import abstract_params, build_model
from repro_torch.tree import tree_leaves

KEYS = {"arch", "shape", "mesh", "kind", "optimizer", "variant", "status",
        "trace_s", "memory", "trace", "roofline"}
ROOFLINE = {"t_compute_ms", "t_memory_ms", "t_collective_ms", "bottleneck",
            "model_flops", "useful_flops_ratio", "bytes_per_device_gib"}
TRACE = {"flops", "bytes_accessed", "collective_bytes",
         "collective_breakdown"}
MEMORY = {"argument_bytes", "params_bytes", "optimizer_bytes",
          "batch_bytes", "cache_bytes", "temp_bytes"}


def test_pairs_are_the_reference_pairs():
    assert list(tdry._pairs()) == list(rdry._pairs())
    assert len(list(tdry._pairs())) == 39


@pytest.mark.parametrize("arch,shape_id,multi_pod", [
    ("llama3.2-3b", "train_4k", False),
    ("falcon-mamba-7b", "decode_32k", False),
    ("granite-moe-1b-a400m", "prefill_32k", True),
])
def test_run_one_writes_the_reference_layout(tmp_path, arch, shape_id,
                                             multi_pod):
    r = tdry.run_one(arch, shape_id, multi_pod, out_dir=str(tmp_path))
    mesh = "2x16x16" if multi_pod else "16x16"
    with open(tmp_path / f"{arch}__{shape_id}__{mesh}.json") as f:
        assert json.load(f) == json.loads(json.dumps(r))
    assert set(r) == KEYS
    assert set(r["roofline"]) == ROOFLINE and set(r["trace"]) == TRACE
    assert set(r["memory"]) == MEMORY
    assert (r["arch"], r["shape"], r["mesh"], r["status"]) == (
        arch, shape_id, mesh, "ok")
    assert r["optimizer"] == ("sgd" if r["kind"] == "train" else None)
    rf = r["roofline"]
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert rf["t_compute_ms"] > 0 and rf["t_memory_ms"] > 0
    assert rf["t_collective_ms"] > 0          # a 16-way model axis
    assert r["trace"]["flops"] > 0 and 0 < rf["useful_flops_ratio"] < 2
    assert rf["bytes_per_device_gib"] * 2 ** 30 == pytest.approx(
        r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"])


def test_variant_file_name_and_rules(tmp_path):
    r = tdry.run_one("llama3.2-3b", "decode_32k", out_dir=str(tmp_path),
                     variant="decode2d,bf16")
    assert r["variant"] == "decode2d,bf16"
    assert os.path.exists(tmp_path /
                          "llama3.2-3b__decode_32k__16x16__decode2d+bf16.json")
    base = tdry.run_one("llama3.2-3b", "decode_32k", out_dir=str(tmp_path))
    bf16 = tdry.run_one("llama3.2-3b", "decode_32k", out_dir=str(tmp_path),
                        variant="bf16")
    # bf16 params halve the params' bytes; decode2d drops their fsdp split
    assert 2 * bf16["memory"]["params_bytes"] == \
        base["memory"]["params_bytes"]
    assert r["memory"]["params_bytes"] > bf16["memory"]["params_bytes"]


def test_kimi_k2_params_stay_on_meta(tmp_path):
    params = abstract_params(build_model(get_config("kimi-k2-1t-a32b")))
    leaves = tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 1e12
    r = tdry.run_one("kimi-k2-1t-a32b", "long_500k", out_dir=str(tmp_path))
    assert r["status"] == "ok" and r["kind"] == "decode"
