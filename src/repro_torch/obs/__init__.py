"""repro_torch.obs — the port's federation telemetry, the counterpart of
the reference's ``repro.obs``.

  schema     typed RoundRecord events, NaN-safe JSONL round-trip, the
             shared row->record construction path, histogram geometry
             (a copy of the reference's: the same JSON text)
  sinks      pluggable record consumers: JSONL file, in-memory ring
             buffer, null, tee
  profiling  stage ranges (gather / local SGD / upload transform /
             aggregate) and host spans (a scan block and its parts, a
             local step and its parts) as torch.profiler ranges (NVTX on
             the card), a profile whose device collection is warmed up,
             and chrome-trace capture
  report     markdown straggler/health report renderer
             (CLI: ``python -m repro_torch.launch.fl_report``)

The server (``repro_torch.core.server``) emits every executed round through
a sink.  The extras come from values each round already pulls to the host,
so telemetry adds no device-to-host copy (``host_syncs`` is unchanged), and
a run with telemetry on computes the same bits as one with it off
(``tests/test_torch_telemetry.py``).
"""
from repro_torch.obs.schema import (HISTORY_KEYS, LOSS_HIST_BINS,
                                    LOSS_HIST_MAX, WORKLOAD_HIST_BINS,
                                    RoundRecord, SchemaError,
                                    histogram_counts, read_jsonl,
                                    record_from_row,
                                    records_from_block_stats)
from repro_torch.obs.sinks import (JsonlSink, NullSink, RingBufferSink, Sink,
                                   TeeSink)
from repro_torch.obs.profiling import (STAGE_AGGREGATE, STAGE_GATHER,
                                       STAGE_LOCAL_SGD, STAGE_UPLOAD,
                                       stage, trace_if, warm_profile)
from repro_torch.obs.report import client_reliability, render_report

__all__ = [
    "HISTORY_KEYS", "LOSS_HIST_BINS", "LOSS_HIST_MAX", "WORKLOAD_HIST_BINS",
    "RoundRecord", "SchemaError", "histogram_counts", "read_jsonl",
    "record_from_row", "records_from_block_stats",
    "JsonlSink", "NullSink", "RingBufferSink", "Sink", "TeeSink",
    "STAGE_AGGREGATE", "STAGE_GATHER", "STAGE_LOCAL_SGD", "STAGE_UPLOAD",
    "stage", "trace_if", "warm_profile",
    "client_reliability", "render_report",
]
