"""The readers of the program's host spans (``fedbench/spans.py`` and the
five metrics that read ``fed.block.*`` and ``fed.local_step.*``) on
hand-made chrome-trace events: each gives the number the events make,
counts only spans inside the window, counts a backward launched from
autograd's own thread, and gives nothing without a trace or without its
spans."""
import pytest

from fedbench.tests import helpers
from fedbench.outcome import Outcome
from fedbench.trace import reduce_events

FL = ("block_host_ms.fl", "block_inputs_ms.fl", "round_replay_ms.fl")
SILO = ("local_step_ms.silo", "sgd_update_ms.silo")


def _span(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "tid": tid}


def _launch(call, ts, corr, device_ts, dur, cat="kernel", tid=1):
    """A host call at ``ts`` on thread ``tid`` and the device record it
    launched, tied by ``corr``."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": call, "ts": ts,
             "dur": 5.0, "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": device_ts,
             "dur": dur, "args": {"correlation": corr}}]


WINDOW = [_span("fedbench.window", 0.0, 10000.0)]


def _fl_events():
    """Two blocks in the window (host 800 and 900 µs beside their replays
    and pulls; inputs and upload 400 and 300 µs; replays of 400 and 500 µs
    on the device) and one before it."""
    ev = WINDOW + [
        _span("fed.block", -3000.0, -1000.0),
        _span("fed.block.replay", -2500.0, -1500.0),
        _span("fed.block", 100.0, 2100.0),
        _span("fed.block.inputs", 100.0, 400.0),
        _span("fed.block.upload", 400.0, 500.0),
        _span("fed.block.replay", 500.0, 1500.0),
        _span("fed.block.pull", 1500.0, 1700.0),
        _span("fed.block.eval", 1700.0, 1900.0),
        _span("fed.block.records", 1900.0, 2100.0),
        _span("fed.block", 3000.0, 5000.0),
        _span("fed.block.inputs", 3000.0, 3200.0),
        _span("fed.block.upload", 3200.0, 3300.0),
        _span("fed.block.replay", 3300.0, 4300.0),
        _span("fed.block.pull", 4300.0, 4400.0),
        _span("fed.block.records", 4400.0, 5000.0)]
    ev += _launch("cudaMemcpyAsync", 410.0, 3, 420.0, 50.0, "gpu_memcpy")
    ev += _launch("cudaGraphLaunch", 600.0, 1, 700.0, 400.0)
    ev += _launch("cudaLaunchKernel", 1750.0, 4, 1760.0, 90.0)
    ev += _launch("cudaGraphLaunch", 3400.0, 2, 3500.0, 500.0)
    return ev


def _silo_events():
    """Two local steps in the window; each step's backward launched from
    thread 2 (autograd's device thread), inside the backward span's time;
    the FedAvg's kernel outside the steps."""
    ev = list(WINDOW)
    for base, corr, upd in ((100.0, 10, 80.0), (1200.0, 20, 120.0)):
        ev += [_span("fed.local_step", base, base + 900.0),
               _span("fed.local_step.forward", base, base + 200.0),
               _span("fed.local_step.backward", base + 200.0, base + 700.0),
               _span("fed.local_step.update", base + 700.0, base + 900.0)]
        ev += _launch("cudaLaunchKernel", base + 50.0, corr + 1,
                      base + 60.0, 100.0)
        ev += _launch("cudaLaunchKernel", base + 300.0, corr + 2,
                      base + 310.0, 300.0, tid=2)
        ev += _launch("cudaLaunchKernel", base + 750.0, corr + 3,
                      base + 760.0, upd)
    ev += _launch("cudaLaunchKernel", 2500.0, 30, 2510.0, 500.0)
    return ev


def _outcome(cell_name, events, counters=None):
    cell = helpers.registry().cell(cell_name)
    return Outcome(cell=cell, end_to_end={}, counters=counters or {},
                   readings={}, attempted=0, failed=0, memory_peak_bytes=0,
                   trace=None if events is None else reduce_events(events))


def _read(metric, outcome):
    return helpers.registry().reader(metric)(outcome)


@pytest.mark.parametrize("metric, want", [
    ("block_host_ms.fl", 0.85),
    ("block_inputs_ms.fl", 0.35),
    ("round_replay_ms.fl", 0.1125),
])
def test_fl_readers(metric, want):
    o = _outcome(helpers.FL_CELL, _fl_events(), {"traced_rounds": 8})
    assert _read(metric, o) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("metric, want", [
    ("local_step_ms.silo", 0.5),
    ("sgd_update_ms.silo", 0.1),
])
def test_silo_readers(metric, want):
    o = _outcome(helpers.SILO_CELL, _silo_events())
    assert _read(metric, o) == pytest.approx(want, rel=1e-9)


def test_a_backward_launched_from_another_thread_is_counted():
    ev = _silo_events()
    o = _outcome(helpers.SILO_CELL, ev)
    backward = o.trace.range_seconds("fed.local_step.backward")
    assert backward == pytest.approx(600e-6, rel=1e-9)
    # the same trace without the second thread's launches reads less
    one = [e for e in ev if e.get("tid", 1) == 1
           or e["cat"] != "cuda_runtime"]
    assert _read("local_step_ms.silo", _outcome(helpers.SILO_CELL, one)) \
        == pytest.approx(0.2, rel=1e-9)


@pytest.mark.parametrize("metric", FL + SILO)
def test_readers_give_nothing_without_a_trace_or_spans(metric):
    cell = helpers.FL_CELL if metric in FL else helpers.SILO_CELL
    counters = {"traced_rounds": 8}
    assert _read(metric, _outcome(cell, None, counters)) is None
    # a program without the spans: the launches alone
    bare = [e for e in (_fl_events() if metric in FL else _silo_events())
            if e["cat"] != "user_annotation"] + WINDOW
    assert _read(metric, _outcome(cell, bare, counters)) is None


def test_the_five_metrics_are_listed_in_their_cells():
    reg = helpers.registry()
    fl = {m["name"] for m in reg.cell(helpers.FL_CELL).per_layer}
    silo = {m["name"] for m in reg.cell(helpers.SILO_CELL).per_layer}
    assert set(FL) <= fl and not set(FL) & silo
    assert set(SILO) <= silo and not set(SILO) & fl
