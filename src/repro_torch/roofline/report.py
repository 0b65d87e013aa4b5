"""Render the roofline table from the port's dry-run JSONs
(``experiments/dryrun_torch/*.json``), as the reference's
``repro/roofline/report.py`` renders its own.

  PYTHONPATH=src python -m repro_torch.roofline.report            # markdown
  PYTHONPATH=src python -m repro_torch.roofline.report --csv
"""
from __future__ import annotations

import argparse
import glob
import json
import os

SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}

ADVICE = {
    ("compute",): "more model parallelism / larger per-chip batch won't help;"
                  " reduce recompute (remat policy) or fuse matmuls",
    ("memory",): "cut HBM traffic: bf16 activations, fused attention kernel "
                 "(no score materialization), fused CE over vocab",
    ("collective",): "reshard: drop FSDP all-gathers (TP-only for decode), "
                     "overlap collectives with compute, reduce-scatter grads",
}

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")


def load(dirname):
    rows = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9),
                             r["mesh"]))
    return rows


def render(rows, csv: bool = False) -> str:
    """The markdown table (and the advice lines) or the CSV of ``rows``."""
    lines = []
    if csv:
        lines.append("arch,shape,mesh,kind,flops_per_dev,bytes_per_dev,"
                     "coll_bytes_per_dev,t_compute_ms,t_memory_ms,"
                     "t_collective_ms,bottleneck,useful_ratio,"
                     "mem_gib_per_dev")
    else:
        lines.append("| arch | shape | mesh | t_comp ms | t_mem ms | "
                     "t_coll ms | bottleneck | useful | GiB/dev |")
        lines.append("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        rf, h = r["roofline"], r["trace"]
        if csv:
            lines.append(
                f"{r['arch']},{r['shape']},{r['mesh']},{r['kind']},"
                f"{h['flops']:.4g},{h['bytes_accessed']:.4g},"
                f"{h['collective_bytes']:.4g},{rf['t_compute_ms']:.4g},"
                f"{rf['t_memory_ms']:.4g},{rf['t_collective_ms']:.4g},"
                f"{rf['bottleneck']},{rf['useful_flops_ratio']:.3f},"
                f"{rf['bytes_per_device_gib']:.2f}")
        else:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{rf['t_compute_ms']:.2f} | {rf['t_memory_ms']:.1f} | "
                f"{rf['t_collective_ms']:.1f} | {rf['bottleneck']} | "
                f"{rf['useful_flops_ratio']:.2f} | "
                f"{rf['bytes_per_device_gib']:.1f} |")
    if not csv:
        lines.append("")
        for k, v in ADVICE.items():
            lines.append(f"- dominant={k[0]}: {v}")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--mesh", default=None, help="filter: 16x16 or 2x16x16")
    args = ap.parse_args()
    rows = load(args.dir)
    if args.mesh:
        rows = [r for r in rows if r["mesh"] == args.mesh]
    print(render(rows, args.csv))


if __name__ == "__main__":
    main()
