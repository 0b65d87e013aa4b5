"""Stage-level profiling of the federated round, the port's counterpart of
the reference's ``repro/obs/profiling.py`` (which uses jax's profiler).

The round is a four-stage pipeline (gather -> local SGD -> upload transform
-> aggregate, ``repro_torch.core.engine``).  ``stage(name)`` marks one stage
as a ``torch.profiler.record_function`` range while a torch profiler
records, which a captured trace shows on the host thread, with the device
kernels launched inside it linked to it; while CUDA is in use it is also an
NVTX range, for external profilers.  It only marks time: it adds no op
and no device synchronisation, so a marked round computes the same bits
as an unmarked one.

The host's own work has spans of the same kind (the SPAN_* names below):
on the scan driver a ``fed.block`` span a block of rounds, with children
for the block's injected inputs, their upload, the replays, the stats
pull, the records and the eval (a capture and a checkpoint too, when the
block holds one), and a ``fed.history`` span for the history view a
server's ``run`` returns; on the silo path and the LM lanes a
``fed.local_step`` span a local step, with its forward, backward and
in-place update.

``trace_if(dir)`` (``fl_train --trace-dir``) captures a
``torch.profiler.profile`` trace of the block it wraps (host activity, and
CUDA activity where a card is present) and writes it under ``dir`` as a
chrome-trace JSON, which perfetto and chrome://tracing open; the stage
ranges appear under the STAGE_* names below.  With ``dir`` unset it does
nothing.  It records through ``warm_profile``, which opens the capture
window only after the device activity collection has taken a burst of
launches, so the block's first device records are not the ones a late
window loses (a window can still, rarely, lose records: see
``PROFILER_WARMUP_LAUNCHES``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

# canonical stage-range names — grep targets in captured traces
STAGE_GATHER = "fed.gather"
STAGE_LOCAL_SGD = "fed.local_sgd"
STAGE_UPLOAD = "fed.upload_transform"
STAGE_AGGREGATE = "fed.aggregate"

# host spans of the scan driver (``FedSAEServer._run_scan``): one a block,
# its children in the order they run
SPAN_BLOCK = "fed.block"
SPAN_BLOCK_INPUTS = "fed.block.inputs"          # injected draws, stacked
SPAN_BLOCK_CAPTURE = "fed.block.capture"        # the first block's capture
SPAN_BLOCK_UPLOAD = "fed.block.upload"          # ``begin_block``
SPAN_BLOCK_REPLAY = "fed.block.replay"          # the block's rounds
SPAN_BLOCK_PULL = "fed.block.pull"              # the stats' host read
SPAN_BLOCK_EVAL = "fed.block.eval"              # where an eval is due
SPAN_BLOCK_RECORDS = "fed.block.records"        # records made and emitted
SPAN_BLOCK_CHECKPOINT = "fed.block.checkpoint"  # where one is written
# the history view over every record that ``FedSAEServer.run`` returns
SPAN_HISTORY = "fed.history"
# host spans of a local step (``RoundEngine._train_in_place``)
SPAN_LOCAL_STEP = "fed.local_step"
SPAN_LOCAL_STEP_FORWARD = "fed.local_step.forward"
SPAN_LOCAL_STEP_BACKWARD = "fed.local_step.backward"
SPAN_LOCAL_STEP_UPDATE = "fed.local_step.update"


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Named profiler range for one pipeline stage or host span.  The
    ``record_function`` range is opened only while a torch profiler is
    recording (opening one costs ~10 µs of host even with none, and a round
    opens 5-8); the NVTX range is pushed only once CUDA is initialised in
    this process (a CPU-only build of torch has no NVTX)."""
    nvtx = torch.cuda.is_initialized()
    with (torch.profiler.record_function(name)
          if torch.autograd._profiler_enabled()
          else contextlib.nullcontext()):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


#: launches made, and synchronised, between enabling the device activity
#: collection and opening the capture window.  In a process that has run
#: many kernels the collection drops the first device records of a window:
#: on an NVIDIA H100 80GB HBM3 (700 W, torch 2.11+cu128), late in a
#: ``chip_smoke.py`` run, the first 8-9 records in 23 of 24 windows opened
#: plainly, and in none of 24 opened after 32 warm-up launches
#: (``scripts/trace_record_probe.py``).  With the dry-run's four profiled
#: whole steps added early in that run, its last windows lost 6 records
#: each despite 32 warm-up launches (``chip_smoke.py``'s retries), so the
#: warm-up takes 256 (~1 ms a window).  Apart
#: from that, 4 of the probe's 96 windows, late or in a fresh process,
#: warm-up or not, lost all or part of their records: a trace that must be
#: whole is checked for it.
PROFILER_WARMUP_LAUNCHES = 256


@contextlib.contextmanager
def warm_profile() -> Iterator["torch.profiler.profile"]:
    """A ``torch.profiler.profile`` of the block (host activity, and CUDA
    activity where a card is present), its capture window opened only
    after ``PROFILER_WARMUP_LAUNCHES`` launches on the current card have
    gone through the enabled device collection; their records fall before
    the window and are not in the result.  Yields the profile, stopped
    when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else []))
    prof.prepare_trace()
    if cuda:
        x = torch.zeros(1, device="cuda")
        for _ in range(PROFILER_WARMUP_LAUNCHES - 1):
            x.add_(1)
        torch.cuda.synchronize()
    prof.start_trace()
    try:
        yield prof
    finally:
        prof.stop_trace()


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a profiler trace of the block into ``trace_dir`` when it is
    set; no-op otherwise — callers wrap their run unconditionally.  The
    trace is written when the block ends, as
    ``<trace_dir>/fed.<pid>.<ms>.pt.trace.json``."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    with warm_profile() as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"fed.{os.getpid()}.{int(time.time() * 1e3)}"
                   f".pt.trace.json"))
