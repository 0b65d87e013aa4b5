"""``repro_torch.obs.profiling`` on the CPU: ``warm_profile`` records the
block it wraps and nothing after it, and ``trace_if`` writes one chrome
trace of its block, or nothing when no directory is given.  The card's
side (every launch of the block with its device record, none of the
warm-up's) is ``test_torch_cuda.py::
test_cuda_warm_profile_keeps_a_device_record_of_every_launch``."""
import glob
import json
import os

import torch

from repro_torch.obs import profiling, stage, trace_if, warm_profile


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
