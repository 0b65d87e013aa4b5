"""Multi-pod dry-run of the port: trace every (architecture x input
shape) as one device's share of its step on the production mesh, and
extract the roofline terms.  The counterpart of ``repro/launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

The reference lowers and compiles each step with XLA on 512 simulated
host devices and reads the partitioned module.  The port traces one
device's share of the step on the meta device (``launch.steps.
trace_step``): nothing is allocated, so it runs on the CPU by nature and
kimi-k2's 1 T parameters cost no memory.  Each run writes
``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<variant>].json``
in the reference's layout, with ``trace`` in place of its ``hlo``,
``memory`` in place of its ``memory_analysis``, ``trace_s`` in place of
its ``lower_s`` and ``compile_s``, and no ``xla_cost_analysis``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

from repro_torch.configs import (ARCH_IDS, get_config, get_shape,
                                 supported_shapes)
from repro_torch.launch.mesh import make_production_mesh, set_mesh
from repro_torch.launch.steps import trace_step
from repro_torch.models.api import build_model
from repro_torch.roofline.analysis import model_flops_estimate, roofline_terms
from repro_torch.sharding.rules import Rules, use_rules

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def variant_for(cfg, shape):
    """long_500k on quadratic-attention families runs the sliding-window
    variant."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        return cfg.replace(attention="sliding_window")
    return cfg


# comma-separable variants, the reference's:
#   bf16     -- bf16 parameters (halves param/grad/collective bytes)
#   tponly   -- drop FSDP sharding (no per-layer param all-gathers)
#   decode2d -- weights 2D-sharded on their output dims, decode batch
#               replicated, caches batch-sharded over data
#   seqscan  -- SSM: sequential scan
#   ssmbf16  -- SSM: bf16 scan inputs
#   chunkN   -- SSM: scan chunk of N
def apply_variants(cfg, variant: str):
    rules_table = {}
    for v in filter(None, (variant or "").split(",")):
        if v == "baseline":
            continue
        elif v == "bf16":
            cfg = cfg.replace(param_dtype="bfloat16")
        elif v == "tponly":
            rules_table["fsdp"] = ()
        elif v == "decode2d":
            rules_table.update({
                "batch": (), "fsdp": (),
                "ff": ("model", "data"),
                "ssm_inner": ("model", "data"),
                "heads": ("model", "data"),
                "vocab": ("model", "data"),
                "expert_ff": ("data",),
            })
        elif v == "seqscan":
            cfg = cfg.replace(ssm_scan="sequential")
        elif v == "ssmbf16":
            cfg = cfg.replace(ssm_input_dtype="bfloat16")
        elif v.startswith("chunk"):
            cfg = cfg.replace(ssm_chunk=int(v[5:]))
        else:
            raise ValueError(f"unknown variant {v!r}")
    return cfg, Rules(table=rules_table)


def run_one(arch: str, shape_id: str, multi_pod: bool = False,
            optimizer: str = "sgd", out_dir: str = OUT_DIR,
            variant: str = "baseline") -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh.name
    n_devices = mesh.devices.size
    shape = get_shape(shape_id)
    cfg = variant_for(get_config(arch), shape)
    cfg, rules = apply_variants(cfg, variant)
    model = build_model(cfg)

    t0 = time.time()
    with set_mesh(mesh), use_rules(rules):
        cost, kind, mem = trace_step(model, shape, mesh, optimizer)
    t_trace = time.time() - t0

    bytes_per_device = mem["argument_bytes"] + mem["temp_bytes"]
    report = roofline_terms(
        cost, n_devices, arch=arch, shape=shape_id, mesh=mesh_name,
        model_flops=model_flops_estimate(cfg, shape),
        bytes_per_device=bytes_per_device)

    result = {
        "arch": arch, "shape": shape_id, "mesh": mesh_name, "kind": kind,
        "optimizer": optimizer if kind == "train" else None,
        "variant": variant,
        "status": "ok",
        "trace_s": round(t_trace, 1),
        "memory": mem,
        "trace": {
            "flops": report.flops,
            "bytes_accessed": report.bytes_accessed,
            "collective_bytes": report.collective_bytes,
            "collective_breakdown": report.collective_breakdown,
        },
        "roofline": {
            "t_compute_ms": report.t_compute * 1e3,
            "t_memory_ms": report.t_memory * 1e3,
            "t_collective_ms": report.t_collective * 1e3,
            "bottleneck": report.bottleneck,
            "model_flops": report.model_flops,
            "useful_flops_ratio": report.useful_ratio,
            "bytes_per_device_gib": bytes_per_device / 2 ** 30,
        },
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant.replace(',', '+')}"
    fname = f"{arch}__{shape_id}__{mesh_name}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=2)
    return result


def _pairs():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_id in supported_shapes(cfg):
            yield arch, shape_id


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "adamw"))
    ap.add_argument("--variant", default="baseline",
                    help="comma-separated: bf16,tponly,decode2d,seqscan,"
                         "ssmbf16,chunkN")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each pair in a fresh process")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args()

    if args.all:
        failures = []
        for arch, shape_id in _pairs():
            if args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_id,
                       "--optimizer", args.optimizer,
                       "--variant", args.variant,
                       "--out-dir", args.out_dir]
                if args.multi_pod:
                    cmd.append("--multi-pod")
                rc = subprocess.run(cmd).returncode
                status = "ok" if rc == 0 else f"FAIL rc={rc}"
                if rc != 0:
                    failures.append((arch, shape_id))
                print(f"[dryrun] {arch} x {shape_id}: {status}", flush=True)
            else:
                try:
                    r = run_one(arch, shape_id, args.multi_pod, args.optimizer,
                                args.out_dir, args.variant)
                    rf = r["roofline"]
                    print(f"[dryrun] {arch} x {shape_id} ({r['mesh']}): ok "
                          f"compute={rf['t_compute_ms']:.2f}ms "
                          f"mem={rf['t_memory_ms']:.2f}ms "
                          f"coll={rf['t_collective_ms']:.2f}ms "
                          f"-> {rf['bottleneck']} ({r['trace_s']}s)",
                          flush=True)
                except Exception:
                    failures.append((arch, shape_id))
                    print(f"[dryrun] {arch} x {shape_id}: FAIL\n"
                          f"{traceback.format_exc()}", flush=True)
        if failures:
            print(f"FAILURES: {failures}")
            sys.exit(1)
        print("dry-run: all pairs traced OK")
        return

    if args.arch is None or args.shape is None:
        ap.error("give --arch and --shape, or --all")
    r = run_one(args.arch, args.shape, args.multi_pod, args.optimizer,
                args.out_dir, args.variant)
    print(json.dumps(r, indent=2))


if __name__ == "__main__":
    main()
