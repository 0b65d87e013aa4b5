"""RoundRecord — the typed per-round event of the port's federation
telemetry, a copy of the reference's ``repro/obs/schema.py`` (numpy and
json only), so that both packages write and read the same JSONL text.

One record per executed round, JSONL-serializable and NaN-safe: JSON has no
NaN literal, so float NaNs are written as ``null`` and decoded back to NaN
through the typed field table (a round whose test-set eval was skipped
round-trips bit-exactly).  Records compare NaN-aware (``NaN == NaN`` within
a record), so ``write -> read -> equality`` is a clean test invariant.

Scalar fields (always present; NaN when unknown) mirror the server's
``history`` keys; the OPTIONAL fields carry the telemetry extras that only
exist when telemetry is on (a server with a sink or ``telemetry=True``):

  ids              [K] cohort client ids
  client_uploaded  [K] 0/1 upload outcome per cohort slot — the per-client
                   reliability signal the health report tabulates
  upload_bytes     simulated client->server bytes this round under the
                   configured upload transform (compression ledger)
  dense_upload_bytes  what the same uploads would cost dense (f32)
  loss_hist        [LOSS_HIST_BINS] histogram of uploader training losses
                   over [0, LOSS_HIST_MAX)
  workload_hist    [WORKLOAD_HIST_BINS] histogram of uploaded epochs e_eff
                   over [0, h_cap)
  lane_occupancy   [S] per-shard executed-lane occupancy (sharded runs;
                   the port has no sharded driver yet)
  screened         uploads rejected by the finite/norm screen this round
                   (present only when the screen is on)
  quarantined      clients currently serving a reliability suspension
                   (present only when quarantine is on)

The histogram binning is the reference's: values are clipped into
[lo, hi), bin = floor((x - lo) / (hi - lo) * bins), in float32.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

# fixed histogram geometry (the reference's)
LOSS_HIST_BINS = 16
LOSS_HIST_MAX = 8.0      # softmax-xent losses; ln(62) ~ 4.1 at init
WORKLOAD_HIST_BINS = 16  # over [0, h_cap) uploaded epochs

# scalar per-round metrics, in the order the server's history carries
HISTORY_KEYS = ("acc", "test_loss", "train_loss", "dropout", "assigned",
                "uploaded", "true_workload", "overflowed", "dropped")

_FLOAT_FIELDS = ("wall_time_s",) + HISTORY_KEYS
_OPT_LIST_FIELDS = ("ids", "client_uploaded", "loss_hist", "workload_hist",
                    "lane_occupancy")
_OPT_SCALAR_FIELDS = ("upload_bytes", "dense_upload_bytes", "screened",
                      "quarantined")


class SchemaError(ValueError):
    """A JSONL line does not validate against the RoundRecord schema."""


def _nan() -> float:
    return float("nan")


@dataclasses.dataclass(eq=False)
class RoundRecord:
    """One executed federated round.  See module docstring for fields."""

    round: int
    wall_time_s: float = dataclasses.field(default_factory=_nan)
    acc: float = dataclasses.field(default_factory=_nan)
    test_loss: float = dataclasses.field(default_factory=_nan)
    train_loss: float = dataclasses.field(default_factory=_nan)
    dropout: float = dataclasses.field(default_factory=_nan)
    assigned: float = dataclasses.field(default_factory=_nan)
    uploaded: float = dataclasses.field(default_factory=_nan)
    true_workload: float = dataclasses.field(default_factory=_nan)
    overflowed: float = dataclasses.field(default_factory=_nan)
    dropped: float = dataclasses.field(default_factory=_nan)
    # telemetry extras (None when metric accumulation was off)
    ids: Optional[List[int]] = None
    client_uploaded: Optional[List[int]] = None
    upload_bytes: Optional[float] = None
    dense_upload_bytes: Optional[float] = None
    loss_hist: Optional[List[float]] = None
    workload_hist: Optional[List[float]] = None
    lane_occupancy: Optional[List[float]] = None
    # fault defenses (None when the screen / quarantine are off)
    screened: Optional[float] = None
    quarantined: Optional[float] = None

    # -- NaN-aware equality (dataclass eq fails on NaN fields) ----------
    def __eq__(self, other) -> bool:
        if not isinstance(other, RoundRecord):
            return NotImplemented

        def same(a, b):
            if isinstance(a, float) and isinstance(b, float):
                return (math.isnan(a) and math.isnan(b)) or a == b
            if isinstance(a, list) and isinstance(b, list):
                return len(a) == len(b) and all(
                    same(x, y) for x, y in zip(a, b))
            return a == b

        return all(same(getattr(self, f.name), getattr(other, f.name))
                   for f in dataclasses.fields(self))

    # -- JSONL serialization -------------------------------------------
    def to_json(self) -> str:
        """One strict-JSON line; float NaN encodes as null."""
        out: Dict = {"round": int(self.round)}
        for name in _FLOAT_FIELDS:
            v = getattr(self, name)
            out[name] = None if math.isnan(v) else v
        for name in _OPT_SCALAR_FIELDS + _OPT_LIST_FIELDS:
            v = getattr(self, name)
            if v is not None:
                out[name] = v
        return json.dumps(out, allow_nan=False)

    @classmethod
    def from_json(cls, line: str) -> "RoundRecord":
        """Parse + validate one JSONL line (SchemaError on mismatch)."""
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise SchemaError(f"not valid JSON: {e}") from None
        if not isinstance(obj, dict):
            raise SchemaError(f"record line must be an object, "
                              f"got {type(obj).__name__}")
        if "round" not in obj or isinstance(obj["round"], bool) \
                or not isinstance(obj["round"], int):
            raise SchemaError("missing/non-int required field 'round'")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise SchemaError(f"unknown fields {sorted(unknown)}")
        kw: Dict = {"round": obj["round"]}
        for name in _FLOAT_FIELDS:
            v = obj.get(name)
            if v is None:
                kw[name] = float("nan")
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                kw[name] = float(v)
            else:
                raise SchemaError(f"field {name!r} must be a number or "
                                  f"null, got {v!r}")
        for name in _OPT_SCALAR_FIELDS:
            v = obj.get(name)
            if v is not None:
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise SchemaError(f"field {name!r} must be a number, "
                                      f"got {v!r}")
                v = float(v)
            kw[name] = v
        for name in _OPT_LIST_FIELDS:
            v = obj.get(name)
            if v is not None:
                if not isinstance(v, list) or any(
                        isinstance(x, bool) or not isinstance(x, (int, float))
                        for x in v):
                    raise SchemaError(f"field {name!r} must be a list of "
                                      f"numbers, got {v!r}")
                v = ([int(x) for x in v] if name in ("ids", "client_uploaded")
                     else [float(x) for x in v])
            kw[name] = v
        return cls(**kw)


# ---------------------------------------------------------------------------
# row -> record: the single construction path of every record
# ---------------------------------------------------------------------------


def record_from_row(t: int, row: Mapping) -> RoundRecord:
    """Build a RoundRecord from a loose per-round row mapping.

    This is the one place raw driver output (numpy scalars, missing keys,
    values already pulled to the host) is normalized: every scalar metric
    the row does not carry is NaN-filled, as the history view fills it,
    and telemetry extras are converted to plain python lists.  The server
    and the silo round build their records through here.
    """
    kw: Dict = {"round": int(t)}
    for name in _FLOAT_FIELDS:
        v = row.get(name)
        kw[name] = float("nan") if v is None else float(v)
    for name in _OPT_SCALAR_FIELDS:
        v = row.get(name)
        kw[name] = None if v is None else float(v)
    for name in _OPT_LIST_FIELDS:
        v = row.get(name)
        if v is not None:
            v = np.asarray(v).tolist()
            v = ([int(x) for x in v]
                 if name in ("ids", "client_uploaded")
                 else [float(x) for x in v])
        kw[name] = v
    return RoundRecord(**kw)


def records_from_block_stats(stats: Mapping, t0: int,
                             n_rounds: int) -> List[RoundRecord]:
    """Slice a block of per-round stats (per-key [block, ...] arrays, as
    the device drivers pull them: ``core.graphs.RoundProgram.pull``) into
    per-round records ``t0 .. t0 + n_rounds - 1``."""
    out = []
    for i in range(n_rounds):
        row = {k: np.asarray(v)[i] for k, v in stats.items()}
        out.append(record_from_row(t0 + i, row))
    return out


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


def histogram_counts(x, w, lo: float, hi: float, bins: int) -> np.ndarray:
    """float32 fixed-bin histogram, the reference's binning: clip into
    [lo, hi), bin = floor(norm * bins)."""
    x = np.clip(np.asarray(x, np.float32), np.float32(lo),
                np.float32(hi) - np.float32(hi - lo) * np.float32(1e-6))
    idx = np.floor((x - np.float32(lo)) / np.float32(hi - lo)
                   * np.float32(bins)).astype(np.int32)
    out = np.zeros(bins, np.float32)
    np.add.at(out, idx, np.asarray(w, np.float32))
    return out


# ---------------------------------------------------------------------------
# JSONL files: optional meta header + record lines
# ---------------------------------------------------------------------------


def read_jsonl(path: str) -> Tuple[Dict, List[RoundRecord]]:
    """Read a telemetry JSONL file -> (meta, records).

    The first line may be a ``{"_meta": {...}}`` header (written by
    JsonlSink); every other non-empty line must validate as a RoundRecord.
    SchemaError carries the 1-based line number on failure.
    """
    meta: Dict = {}
    records: List[RoundRecord] = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            if lineno == 1:
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError as e:
                    raise SchemaError(f"{path}:1: not valid JSON: {e}") \
                        from None
                if isinstance(obj, dict) and "_meta" in obj:
                    if not isinstance(obj["_meta"], dict):
                        raise SchemaError(f"{path}:1: _meta must be an "
                                          f"object")
                    meta = obj["_meta"]
                    continue
            try:
                records.append(RoundRecord.from_json(line))
            except SchemaError as e:
                raise SchemaError(f"{path}:{lineno}: {e}") from None
    return meta, records
