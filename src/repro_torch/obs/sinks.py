"""Pluggable RoundRecord sinks, a copy of the reference's
``repro/obs/sinks.py``.

A sink receives every executed round's :class:`repro_torch.obs.schema.
RoundRecord` through ``emit``; the server emits once per round, from values
the round has already pulled to the host, so emitting adds no
device-to-host copy.

  NullSink        drops everything (the telemetry-off default)
  RingBufferSink  in-memory, optionally bounded; backs the server's
                  ``history`` view
  JsonlSink       one strict-JSON line per record, optional ``{"_meta":
                  {...}}`` header line; read back with
                  ``repro_torch.obs.schema.read_jsonl``, rendered by
                  ``python -m repro_torch.launch.fl_report``
  TeeSink         fan-out to several sinks
"""
from __future__ import annotations

import collections
import json
from typing import Dict, List, Optional

from repro_torch.obs.schema import RoundRecord


class Sink:
    """Interface: ``emit`` each record, ``close`` when the run ends."""

    def emit(self, record: RoundRecord) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "Sink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullSink(Sink):
    def emit(self, record: RoundRecord) -> None:
        pass


class RingBufferSink(Sink):
    """Keep the last ``capacity`` records in memory (None = unbounded)."""

    def __init__(self, capacity: Optional[int] = None):
        self._buf: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, record: RoundRecord) -> None:
        self._buf.append(record)

    @property
    def records(self) -> List[RoundRecord]:
        return list(self._buf)

    @property
    def last(self) -> Optional[RoundRecord]:
        return self._buf[-1] if self._buf else None

    def __len__(self) -> int:
        return len(self._buf)


class JsonlSink(Sink):
    """Append records to ``path`` as JSON lines.

    ``meta`` (run-level context: algo, dataset, config, ...) is written as
    a ``{"_meta": {...}}`` first line so reports can label themselves.
    Writes go through the file object's normal buffering; ``close`` (or the
    context manager) flushes.  Keep the emitted volume in mind: one record
    is a few hundred bytes, so even paper-scale runs stay in the MBs.

    ``append=True`` (crash recovery) reopens an existing trace and appends
    records after the ones already on disk; the ``meta`` header is only
    ever written to a fresh file, so a resumed run keeps the original
    run's header line.
    """

    def __init__(self, path: str, meta: Optional[Dict] = None,
                 append: bool = False):
        self.path = path
        self._f = open(path, "a" if append else "w")
        if meta is not None and not append:
            self._f.write(json.dumps({"_meta": meta}, allow_nan=False)
                          + "\n")

    def emit(self, record: RoundRecord) -> None:
        self._f.write(record.to_json() + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class TeeSink(Sink):
    def __init__(self, *sinks: Sink):
        self.sinks = sinks

    def emit(self, record: RoundRecord) -> None:
        for s in self.sinks:
            s.emit(record)

    def close(self) -> None:
        for s in self.sinks:
            s.close()
