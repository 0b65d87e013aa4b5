"""The port's federation telemetry (``repro_torch.obs``) against the
reference's (``repro.obs``), on the same numpy-made inputs, on the CPU.

- Schema, bitwise: ``to_json`` text equals the reference's (NaN fields
  included), ``from_json`` and ``read_jsonl`` give the same fields, meta
  and line numbers, malformed lines are refused by both, and
  ``histogram_counts`` bins the same (values at lo, at hi, below 0, zero
  weights).
- Host rounds with telemetry on: 3 MCLR iid rounds and 2 MLP + topk_q8
  rounds, the port with the reference's injected draws.  Cohort ids,
  upload outcomes, byte ledger and workload histograms equal, train loss
  within 2e-5 (the local-SGD bound), and the port's loss histogram equals
  the reference's binning of the port's own losses.
- Telemetry on against off: params and history bitwise, ``host_syncs``
  equal.
- Reports and files: the port's report string equals the reference's, the
  reference reads the port's JSONL file to the same records, and its
  ``scripts/fl_report.py`` accepts the file.
- The silo sink (smoke Llama, 3 rounds) and the CLI (``--metrics-out``,
  ``--trace-dir``, ``python -m repro_torch.launch.fl_report``).
"""
import glob
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core.server import FedSAEServer as JServer
from repro.core.server import ServerConfig as JConfig
from repro.data.federated import make_femnist_like as jfemnist
from repro.obs import report as jreport
from repro.obs import schema as jschema
from repro_torch.configs import get_config
from repro_torch.core.server import FedSAEServer as TServer
from repro_torch.core.server import ServerConfig as TConfig
from repro_torch.core.silo import SiloFedSAE
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.launch import fl_report, fl_train
from repro_torch.models.api import build_model
from repro_torch.obs import (LOSS_HIST_BINS, LOSS_HIST_MAX, STAGE_AGGREGATE,
                             STAGE_GATHER, STAGE_LOCAL_SGD, STAGE_UPLOAD,
                             JsonlSink, RingBufferSink, RoundRecord,
                             SchemaError, histogram_counts, read_jsonl,
                             record_from_row, render_report)
from test_torch_server import CFG_KW, DS_KW, _reference_draws
from torch_cases import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 2e-5
STAGES = (STAGE_GATHER, STAGE_LOCAL_SGD, STAGE_UPLOAD, STAGE_AGGREGATE)

# ---------------------------------------------------------------------------
# schema, bitwise
# ---------------------------------------------------------------------------


def _rows(seed=0):
    """Seeded per-round rows: NaN scalars, numpy scalars and arrays, every
    optional field present in some row and absent in others."""
    rng = np.random.default_rng(seed)
    rows = [{}]
    for t in range(1, 6):
        K = int(rng.integers(2, 7))
        row = {k: rng.normal() * 10.0 ** rng.integers(-8, 8)
               for k in jschema.HISTORY_KEYS if rng.random() < 0.8}
        row["test_loss"] = float("nan") if t % 2 else np.float32(
            rng.random())
        row["wall_time_s"] = np.float64(rng.random() * 1e-3)
        row["ids"] = rng.choice(100, K, replace=False)
        row["client_uploaded"] = (rng.random(K) < 0.7).astype(np.int32)
        if t % 3:
            row["upload_bytes"] = float(rng.integers(0, 10**9))
            row["dense_upload_bytes"] = np.int64(rng.integers(0, 10**9))
            row["loss_hist"] = rng.random(16).astype(np.float32)
            row["workload_hist"] = np.arange(16, dtype=np.float32)
        if t == 4:
            row["lane_occupancy"] = [0.5, 1.0, 1 / 3]
            row["screened"], row["quarantined"] = 2, np.float32(1)
        rows.append(row)
    return rows


def test_to_json_text_and_from_json_equal_reference():
    for t, row in enumerate(_rows()):
        ours, theirs = record_from_row(t, row), jschema.record_from_row(t,
                                                                       row)
        line = ours.to_json()
        assert line == theirs.to_json()
        back, jback = RoundRecord.from_json(line), \
            jschema.RoundRecord.from_json(line)
        assert back == ours and back.to_json() == jback.to_json()
        for name in jschema.RoundRecord.__dataclass_fields__:
            a, b = getattr(back, name), getattr(jback, name)
            assert type(a) is type(b), name
            assert a == b or (isinstance(a, float) and math.isnan(a)
                              and math.isnan(b)), name
    assert list(RoundRecord.__dataclass_fields__) == list(
        jschema.RoundRecord.__dataclass_fields__)


@pytest.mark.parametrize("line", [
    "not json",
    "[1, 2]",
    '{"acc": 0.5}',
    '{"round": true}',
    '{"round": 1, "acc": "high"}',
    '{"round": 1, "ids": [1, "a"]}',
    '{"round": 1, "nonsense": 3}',
])
def test_malformed_lines_refused_by_both(line):
    with pytest.raises(SchemaError) as ours:
        RoundRecord.from_json(line)
    with pytest.raises(jschema.SchemaError) as theirs:
        jschema.RoundRecord.from_json(line)
    assert str(ours.value) == str(theirs.value)


def test_read_jsonl_meta_and_line_numbers_equal_reference(tmp_path):
    good = tmp_path / "good.jsonl"
    with JsonlSink(str(good), meta={"algo": "ira", "rounds": 3}) as sink:
        for t, row in enumerate(_rows()[:3]):
            sink.emit(record_from_row(t, row))
    meta, recs = read_jsonl(str(good))
    jmeta, jrecs = jschema.read_jsonl(str(good))
    assert meta == jmeta == {"algo": "ira", "rounds": 3}
    assert [r.to_json() for r in recs] == [r.to_json() for r in jrecs]
    bad = tmp_path / "bad.jsonl"
    bad.write_text(good.read_text() + "\n" + '{"round": 1, "x": 2}\n')
    with pytest.raises(SchemaError, match=":6:") as ours:
        read_jsonl(str(bad))
    with pytest.raises(jschema.SchemaError) as theirs:
        jschema.read_jsonl(str(bad))
    assert str(ours.value) == str(theirs.value)


def test_histogram_counts_equal_reference():
    rng = np.random.default_rng(3)
    lo, hi, bins = 0.0, 8.0, 16
    x = np.r_[rng.uniform(-2, 10, 40), lo, hi, -1.0, hi - 1e-7, 1e9,
              np.float32(hi) * (1 - 1e-6)]
    w = np.r_[rng.random(40), 1.0, 1.0, 0.0, 2.0, 0.0, 1.0]
    w[::7] = 0.0
    for lo_, hi_ in ((lo, hi), (0.0, 24.0), (-1.5, 2.5)):
        ours = histogram_counts(x, w, lo_, hi_, bins)
        theirs = jschema.histogram_counts(x, w, lo_, hi_, bins)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


# ---------------------------------------------------------------------------
# host rounds with telemetry on, against the reference's
# ---------------------------------------------------------------------------

RUNS = {"mclr_iid": (3, dict(sampling="iid")),
        "mlp_topk": (2, dict(model="mlp", sampling="iid",
                             upload_compress="topk_q8", topk_frac=0.1))}


def _port(jsrv, rounds, kw, **server_kw):
    """The port's server with the reference's init and draws; its rounds'
    losses and budgets are kept in ``srv.rows``."""
    tds = tfemnist(**DS_KW)
    srv = TServer(tds, cfg=TConfig(algo="ira", device="cpu",
                                   **dict(CFG_KW, rounds=rounds, **kw)),
                  init_params=jax.tree.map(np.asarray, jsrv.params),
                  data_draws=_reference_draws(
                      0, rounds, jsrv.max_iters, 4, int(tds.sizes.max()),
                      "iid"), **server_kw)
    srv.rows, run_round = [], srv.run_round

    def recorded(t):
        row = run_round(t)
        srv.rows.append(row)
        return row

    srv.run_round = recorded
    return srv


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request):
    """(reference server, port server with a sink, port server without
    telemetry), each run for the case's rounds."""
    rounds, kw = RUNS[request.param]
    jsrv = JServer(jfemnist(**DS_KW), cfg=JConfig(
        algo="ira", **dict(CFG_KW, rounds=rounds, **kw)), telemetry=True)
    on = _port(jsrv, rounds, kw, sink=RingBufferSink())
    off = _port(jsrv, rounds, kw)
    jsrv.run()
    on.run()
    off.run()
    return jsrv, on, off


def test_host_round_extras_match_reference(runs):
    jsrv, srv, _ = runs
    recs, jrecs = srv._records.records, jsrv._records.records
    assert len(recs) == len(jrecs) == srv.cfg.rounds
    assert srv.sink.records == recs
    for rec, jrec, row in zip(recs, jrecs, srv.rows):
        for name in ("ids", "client_uploaded", "upload_bytes",
                     "dense_upload_bytes", "workload_hist", "dropout",
                     "dropped", "assigned", "uploaded", "true_workload"):
            assert getattr(rec, name) == getattr(jrec, name), name
        assert rec.lane_occupancy is None and rec.screened is None
        assert rec.quarantined is None
        np.testing.assert_allclose(rec.train_loss, jrec.train_loss,
                                   rtol=TOL, atol=TOL)
        up = (row["n_iters"] > 0).astype(np.float32)
        assert rec.loss_hist == jschema.histogram_counts(
            row["losses"], up, 0.0, LOSS_HIST_MAX, LOSS_HIST_BINS).tolist()
        assert sum(rec.loss_hist) == sum(rec.client_uploaded)
    if srv.engine.compressing:
        assert all(r.upload_bytes < r.dense_upload_bytes for r in recs
                   if sum(r.client_uploaded))


def test_telemetry_is_inert(runs):
    _, on, off = runs
    assert on.telemetry and not off.telemetry
    for k in on.params:
        assert on.params[k].numpy().tobytes() == \
            off.params[k].numpy().tobytes()
    h_on, h_off = on.history, off.history
    assert list(h_on) == list(h_off) == list(jschema.HISTORY_KEYS)
    for k in h_on:
        np.testing.assert_array_equal(h_on[k], h_off[k])
    assert on.host_syncs == off.host_syncs == on.cfg.rounds
    assert all(r.loss_hist is None and r.client_uploaded is None
               for r in off._records.records)
    assert on.wall_times == [r.wall_time_s for r in on._records.records]


def test_report_and_file_equal_reference(runs, tmp_path):
    _, srv, _ = runs
    path = str(tmp_path / "run.jsonl")
    meta = {"path": "flat", "algo": "ira", "rounds": srv.cfg.rounds}
    with JsonlSink(path, meta=meta) as sink:
        for rec in srv._records.records:
            sink.emit(rec)
    jmeta, jrecs = jschema.read_jsonl(path)
    assert jmeta == meta
    assert [r.to_json() for r in jrecs] == [
        r.to_json() for r in srv._records.records]
    for top in (10, 2):
        ours = render_report(meta, srv._records.records, top=top)
        assert ours == jreport.render_report(jmeta, jrecs, top=top)
    for head in ("## Round summary", "## Stragglers",
                 "## Per-client reliability", "## Upload ledger",
                 "## Throughput"):
        assert head in ours
    n = str(srv.cfg.rounds)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "fl_report.py"),
         path, "--validate", "--expect-rounds", n], capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"fl_report: OK — {n} valid round records")


# ---------------------------------------------------------------------------
# the silo sink and the CLI
# ---------------------------------------------------------------------------


def test_silo_path_emits_records():
    cfg = get_config("llama3.2-3b", smoke=True)
    ring = RingBufferSink()
    fed = SiloFedSAE(build_model(cfg), n_silos=2, lr=5e-3, max_steps=4,
                     sink=ring, device="cpu")
    ri = np.random.default_rng(0)
    toks = np.stack([ri.integers(0, cfg.vocab_size, (4, 2, 32))
                     for _ in range(2)]).astype(np.int32)
    for _ in range(3):
        fed.run_round({"tokens": toks, "labels": toks}, np.array([100, 500]))
    assert len(ring) == 3
    assert [r.round for r in ring.records] == [0, 1, 2]
    rec = ring.last
    assert rec.train_loss == fed.stats["loss"][-1]
    assert rec.ids == [0, 1]
    assert rec.client_uploaded == (fed.last_n_steps > 0).astype(int).tolist()
    assert math.isfinite(rec.wall_time_s) and rec.wall_time_s > 0
    assert RoundRecord.from_json(rec.to_json()) == rec


def test_cli_metrics_trace_and_report(tmp_path, capsys):
    path, trace = str(tmp_path / "m.jsonl"), str(tmp_path / "trace")
    fl_train.main(["--device", "cpu", "--rounds", "2", "--quiet", "--model",
                   "mlp", "--sampling", "iid", "--compress", "topk_q8",
                   "--metrics-out", path, "--trace-dir", trace])
    assert f"metrics: {path}" in capsys.readouterr().out
    meta, recs = read_jsonl(path)
    assert meta == {"rounds": 2, "driver": "host", "backend": "xla",
                    "path": "flat", "dataset": "femnist", "algo": "ira",
                    "model": "mlp"}
    assert [r.round for r in recs] == [0, 1]
    assert all(r.upload_bytes < r.dense_upload_bytes for r in recs)
    (tfile,) = glob.glob(os.path.join(trace, "*.pt.trace.json"))
    with open(tfile) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(STAGES) <= names

    assert fl_report.main([path, "--validate", "--expect-rounds", "2"]) == 0
    assert capsys.readouterr().out == (
        "fl_report: OK — 2 valid round records, meta keys "
        f"{sorted(meta)}\n")
    assert fl_report.main([path, "--expect-rounds", "3"]) == 1
    assert capsys.readouterr().err == (
        "fl_report: INVALID — expected 3 round records, found 2\n")
    out = str(tmp_path / "report.md")
    assert fl_report.main([path, "--out", out]) == 0
    with open(out) as f:
        assert f.read() == render_report(meta, recs)
