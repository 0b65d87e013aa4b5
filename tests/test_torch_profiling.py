"""``repro_torch.obs.profiling`` on the CPU: ``warm_profile`` records the
block it wraps and nothing after it, and ``trace_if`` writes one chrome
trace of its block, or nothing when no directory is given.  The card's
side (every launch of the block with its device record, none of the
warm-up's) is ``test_torch_cuda.py::
test_cuda_warm_profile_keeps_a_device_record_of_every_launch``.

``chip_smoke.py``'s ``profiled`` counts no window that lost a device
record: on fake windows (a host launch without its kernel event) it
profiles again, and raises once every window lost one."""
import glob
import importlib.util
import json
import os

import pytest
import torch

from repro_torch.obs import profiling, stage, trace_if, warm_profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_warm_profile_records_the_block_only():
    assert not torch.autograd._profiler_enabled()
    with warm_profile() as prof:
        assert torch.autograd._profiler_enabled()
        with stage("fed.inside"):
            torch.ones(3).add_(1)
    assert not torch.autograd._profiler_enabled()
    keys = {e.key for e in prof.key_averages()}
    assert {"fed.inside", "aten::add_"} <= keys
    with stage("fed.after"):
        torch.ones(3)
    assert "fed.after" not in {e.key for e in prof.key_averages()}
    # more warm-up launches than the first 8-9 device records a late
    # window lost (scripts/trace_record_probe.py on the card)
    assert profiling.PROFILER_WARMUP_LAUNCHES > 9


def test_trace_if_writes_one_trace_of_its_block(tmp_path):
    with trace_if(None):
        assert not torch.autograd._profiler_enabled()
    trace = str(tmp_path / "trace")
    with trace_if(trace):
        with stage("fed.gather"):
            torch.arange(4).sum()
    (path,) = glob.glob(os.path.join(trace, "fed.*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "fed.gather" in names
    assert not torch.autograd._profiler_enabled()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _window(recorded):
    """The complete events of a fake window: two kernel launches on the
    host (a runtime and a driver call), and a kernel event for those whose
    correlation id is in ``recorded``; a memcpy call, which launches no
    kernel, without any."""
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx",
         "args": {"correlation": 12}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "args": {"correlation": 13}},
    ]
    return events + [{"ph": "X", "cat": "kernel", "name": f"k{c}",
                      "args": {"correlation": c}} for c in recorded]


def test_unrecorded_launches_counts_a_host_launch_without_its_kernel():
    cs = _chip_smoke()
    assert cs.unrecorded_launches(_window([11, 12])) == (0, 2)
    assert cs.unrecorded_launches(_window([11])) == (1, 2)
    assert cs.unrecorded_launches(_window([])) == (2, 2)


@pytest.mark.parametrize("lossy", [1, 2, 3])
def test_profiled_profiles_again_a_window_that_lost_device_records(
        monkeypatch, lossy):
    """The first ``lossy`` windows lose the record of one launch: the call
    is profiled again, each retry printed, and the counts come from the
    first whole window; if every window lost one, ``TraceIncomplete``."""
    cs = _chip_smoke()
    windows, calls = [], []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cs, "trace_events", lambda prof: windows.pop(0))
    windows += [_window([12])] * lossy + [_window([11, 12])]
    if lossy < cs.TRACE_ATTEMPTS:
        out = cs.profiled(torch, lambda: calls.append(1))
        assert len(calls) == lossy + 1 and len(out) == 5
    else:
        with pytest.raises(cs.TraceIncomplete):
            cs.profiled(torch, lambda: calls.append(1))
        assert len(calls) == cs.TRACE_ATTEMPTS
