"""The result line's keys and order, and the no-JAX check by whole
top-level module names."""
import json

from fedbench.tests import helpers
from fedbench import run as bench_run
from fedbench.outcome import Outcome
from fedbench.trace import reduce_events


def _outcome(cell, trace=None):
    return Outcome(cell=cell, end_to_end={"rounds_per_s": 900.5,
                                          "setup_s": 12.25},
                   counters={"rounds": 256, "window_s": 0.3,
                             "host_syncs": 32, "executed_iters": 40000,
                             "K": 10, "max_n": 400, "max_iters": 960,
                             "B": 10, "feat": 784, "C": 26,
                             "traced_rounds": 16},
                   readings={"plan_mismatches": 0.0,
                             "train_loss_gap": 1e-8, "test_loss_gap": 1e-8,
                             "first_update_gap": 1e-9, "change_gap": 1e-9},
                   attempted=256, failed=0, memory_peak_bytes=123,
                   trace=trace)


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "fedbench.window",
           "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 10.0, "dur": 5.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "kernel", "name": "fed_gather_kernel(int)",
           "ts": 100.0, "dur": 300.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 600.0,
           "dur": 200.0}]
    return reduce_events(ev)


def test_untraced_line_has_exactly_the_keys():
    cell = helpers.registry().cell(helpers.FL_CELL)
    line = bench_run.result_line(helpers.registry(), cell, _outcome(cell),
                                 False, {"platform": "gpu", "kind": "x",
                                         "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"rounds_per_s", "setup_s"}
    assert line["correct"] is True
    assert set(line["checks"]) == set(cell.traffic["limits"])
    json.dumps(line)


def test_traced_line_carries_busy_window_and_breakdown():
    cell = helpers.registry().cell(helpers.FL_CELL)
    tr = _trace()
    assert abs(tr.busy_s - 300e-6) < 1e-12
    assert abs(tr.window_s - 1e-3) < 1e-12
    line = bench_run.result_line(helpers.registry(), cell,
                                 _outcome(cell, tr), True,
                                 {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["breakdown"]["device_ops"][0][0] == "fed_gather_kernel"
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert abs(gaps["host: aten::copy_"] - 600e-6) < 1e-12
    assert abs(gaps["host: python"] - 100e-6) < 1e-12
    m = line["metrics"]
    assert "rounds_per_s" not in m and "setup_s" not in m
    assert abs(m["device_idle_share.fl"]["value"] - 70.0) < 1e-9
    assert m["host_syncs_per_round.fl"]["value"] == 0.125
    assert "fed_local_sgd_mclr_roofline" not in m   # nothing to read


def test_a_failed_reading_makes_the_line_incorrect():
    cell = helpers.registry().cell(helpers.FL_CELL)
    o = _outcome(cell)
    o.readings["change_gap"] = 10 * cell.traffic["limits"]["change_gap"]
    line = bench_run.result_line(helpers.registry(), cell, o, False, {})
    assert line["correct"] is False
    assert list(line)[-1] == "checks"


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.core.server", "fedbench", "jaxtyping",
            "reprolib", "numpy"]
    assert bench_run.forbidden_modules(mods) == []
    assert bench_run.forbidden_modules(mods + ["repro.core"]) == [
        "repro.core"]
    assert bench_run.forbidden_modules(["jax.numpy", "jaxlib", "flax",
                                        "repro"]) == [
        "flax", "jax.numpy", "jaxlib", "repro"]


def test_the_harness_and_the_reference_load_no_jax():
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import fedbench.run, fedbench.drivers.fl_scan, "
            "fedbench.drivers.silo, fedbench.reference.mamba_lm, "
            "fedbench.reference.fedsae_mclr, fedbench.control\n"
            "import repro_torch.core.server, repro_torch.core.silo\n"
            "print(fedbench.run.forbidden_modules())\n"
            % (helpers.ROOT, helpers.SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    import ast
    import os
    ref = os.path.join(helpers.ROOT, "fedbench", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax"), (f, n)
