"""On a card: each cell runs through ``fedbench/run.py`` and comes out
correct, with the line's keys; the control comes out not correct."""
import json
import os
import subprocess
import sys

import pytest

from fedbench.tests import helpers


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [helpers.FL_CELL, helpers.SILO_CELL])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cell, trace):
    _need_card()
    out = subprocess.run(
        [sys.executable, os.path.join(helpers.ROOT, "fedbench", "run.py"),
         "--workload", cell, "--seed", str(helpers.SEED), "--seconds", "3",
         "--trace", str(trace)], capture_output=True, text=True,
        timeout=900, cwd=helpers.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.cuda
def test_fl_control_is_not_correct_on_the_card():
    _need_card()
    from fedbench.reference.compare import judge
    cell = helpers.registry().cell(helpers.FL_CELL)
    driver = helpers.registry().driver(cell.driver)
    job = helpers.job(cell)
    job.device = "cuda"
    out = driver.control(job, ["program", "control"], "tf32")
    assert judge(out["program"], cell.traffic["limits"])[0]
    assert not judge(out["control"], cell.traffic["limits"])[0]
