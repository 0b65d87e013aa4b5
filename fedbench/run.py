"""Run one cell of the benchmark once and print its result line.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell's files are found by name
(``fedbench/registry.py``); the program under test is ``repro_torch`` in
``src/``.  With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a traced
window.  The last lines on standard error, and the last key of the line,
are the numbers that decided ``correct``, each beside its limit.  A run
without enough CUDA cards, or whose process holds JAX or the JAX package
once the window has closed, prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def cache_environment(root: str = ROOT):
    """Every build and kernel cache at a fixed directory inside the
    checkout, no JAX pulled in by a library, and one host thread for the
    CPU's parallel ops: the program's host work is a single thread of
    launches, and a pool of spinning threads competes with it for the
    cores a one-card machine shares with its host."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    cache = os.path.join(root, ".fedbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def result_line(registry, cell, outcome, trace: bool, device_info):
    """The result's dict, its keys in the order the line prints them."""
    from fedbench.reference.compare import judge
    correct, checks = judge(outcome.readings, cell.traffic["limits"])
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = registry.reader(m["name"])(outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics,
            "device": dict(device_info,
                           memory_peak_bytes=outcome.memory_peak_bytes)}
    if trace and outcome.trace is not None:
        line["device"]["busy_s"] = outcome.trace.busy_s
        line["device"]["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.device_ops(),
                             "idle_gaps": outcome.trace.idle_gaps()}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    return line


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0]


def _finite(x):
    """JSON has no inf or NaN: write them as strings."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_environment()
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    from fedbench.outcome import Job
    from fedbench.registry import Registry
    registry = Registry(ROOT)
    cell = registry.cell(args.workload)
    import torch
    torch.set_num_threads(1)
    chips = int(cell.entry["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"fedbench: {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {cards}", file=sys.stderr)
        return 2
    job = Job(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device="cuda", t_start=T_START)
    outcome = registry.driver(cell.driver).run(job)
    held = forbidden_modules()
    if held:
        print(f"fedbench: the run holds JAX or the JAX package: {held}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "card": power_limit()}
    line = _finite(result_line(registry, cell, outcome, bool(args.trace),
                               info))
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
