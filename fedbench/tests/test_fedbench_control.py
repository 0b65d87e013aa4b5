"""The controls come out not correct: the reference one precision below
the configuration's, put in the program's place, fails the cell's limits
where the program passes them.  The FL cell at its own size (the CPU
holds it), the silo cell at a two-layer width-64 copy."""
import pytest

from fedbench.control import LOWER, config_precision
from fedbench.reference.compare import judge
from fedbench.tests import helpers


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_fl_control_fails_where_the_program_passes(seed):
    cell = helpers.registry().cell(helpers.FL_CELL)
    assert LOWER[config_precision(cell.config)] == "tf32"
    out = helpers.registry().driver(cell.driver).control(
        helpers.job(cell, seed=seed), ["program", "control"], "tf32")
    limits = cell.traffic["limits"]
    assert judge(out["program"], limits)[0], out["program"]
    assert not judge(out["control"], limits)[0], out["control"]


@pytest.mark.parametrize("seed", [1, 2])
def test_silo_control_separates_from_the_program(seed):
    # at this size the gaps are smaller than at the cell's: the control
    # reads at least three times the program on the number the limit
    # separates them by, as at the cell's own size
    cell = helpers.tiny_silo("bfloat16")
    assert LOWER[config_precision(cell.config)] == "fp8"
    out = helpers.registry().driver(cell.driver).control(
        helpers.job(cell, seed=seed), ["program", "control"], "fp8")
    assert judge(out["program"], cell.traffic["limits"])[0], out["program"]
    key = "first_update_median_gap"
    assert out["control"][key] >= 3 * out["program"][key], out
