"""Readings that the limits of ``correct`` are set from, for one cell,
over many seeds in one process:

    python3 fedbench/control.py --workload <cell> --seeds 1,2,3 \\
        --modes program,control,fault:half_batch,fault:altered

``program`` compares the program's checked rounds with the reference,
``control`` the reference computed one precision below the
configuration's (float32 -> TF32, bfloat16 -> fp8, emulated; or the one
``--precision`` names) in the program's place, and ``fault:<name>`` the reference with a fault planted
(``unchanged``, ``half_batch``, ``altered``).  One JSON line a seed; the
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: the precision one step below each configuration's
LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def config_precision(config) -> str:
    return config.get("compute_dtype", config.get("dtype"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default="",
                    help="the control's precision (default: one step "
                         "below the configuration's)")
    args = ap.parse_args(argv)
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    from fedbench.outcome import Job
    from fedbench.registry import Registry
    from fedbench.run import cache_environment
    cache_environment()
    registry = Registry(ROOT)
    cell = registry.cell(args.workload)
    driver = registry.driver(cell.driver)
    precision = (args.precision
                 or LOWER[config_precision(cell.config)])
    modes = args.modes.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        job = Job(cell=cell, seed=seed, seconds=0.0, trace=False,
                  device=args.device, t_start=t0)
        out = driver.control(job, modes, precision)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": precision,
                          "seconds": time.perf_counter() - t0, **out},
                         default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
