"""Every option of the reference's federated surface is accepted by the
port at the reference's default, and every value the port does not run
fails with a message that names its ROADMAP item.

The options are enumerated from the reference itself: the fields of
``repro.core.server.ServerConfig``, the flags of the ``repro.launch.fl_train``
parser, and the keyword arguments of ``FedSAEServer.__init__`` and
``FedSAEServer.run``.  Each non-default value below is either one the port
supports (it must be accepted) or one it refuses (``ValueError`` or
``NotImplementedError`` from the server, ``SystemExit`` from argparse, with
"ROADMAP" and the item in the message).  The telemetry, fault, checkpoint
and device-driver options are also driven through CPU rounds, which shows
that they do their job.
"""
import argparse
import contextlib
import dataclasses
import inspect
import json
import os
import tempfile

import pytest
import torch.distributed as dist

import repro.launch.fl_train as rfl
from repro.core.server import FedSAEServer as RServer
from repro.core.server import ServerConfig as RConfig
from repro_torch.checkpoint import list_checkpoints
from repro_torch.core.server import CommConfig as TComm
from repro_torch.core.server import ComputeConfig as TCompute
from repro_torch.core.server import FedSAEServer as TServer
from repro_torch.core.server import RobustnessConfig as TRobustness
from repro_torch.core.server import ServerConfig as TConfig
from repro_torch.data.federated import make_femnist_like, make_sent140_like
from repro_torch.faults import FaultModel
from repro_torch.launch import fl_train as tfl
from repro_torch.obs import RingBufferSink, read_jsonl
from torch_cases import one_torch_thread  # noqa: F401

OK, REFUSED = True, False

#: ServerConfig field -> [(non-default value, accepted by the port)]
FIELD_CASES = {
    "algo": [("fassa", OK), ("oracle", OK)],
    "n_selected": [(5, OK)],
    "lr": [(0.1, OK)],
    "batch_size": [(5, OK)],
    "rounds": [(3, OK)],
    "fixed_epochs": [(5.0, OK)],
    "h_cap": [(12.0, OK)],
    "init_pair": [((2.0, 3.0), OK)],
    "U": [(5.0, OK)],
    "alpha": [(0.9, OK)],
    "gamma1": [(2.0, OK)],
    "gamma2": [(0.5, OK)],
    "al_rounds": [(2, OK)],
    "beta": [(0.1, OK)],
    "prox_mu": [(0.2, OK)],
    "aggregator": [("fedprox", OK), ("trimmed_mean", OK),
                   ("median", OK)],
    "trim_ratio": [(0.2, OK)],
    "selection": [("active", OK), ("loss_proportional", OK)],
    "sampling": [("iid", OK)],
    "backend": [("pallas", OK)],
    "driver": [("scan", OK)],
    "block_size": [(8, OK)],
    "mesh_shards": [(1, OK)],
    "cohort_capacity": [("auto", OK), (4, OK)],
    "prefetch": [("double_buffer", OK)],
    "fused_generic": [(False, OK)],
    "upload_compress": [("topk_q8", OK)],
    "topk_frac": [(0.2, OK)],
    "agg_weighted": [(True, OK)],
    "n_byzantine": [(1, OK)],
    "faults": [(FaultModel(corrupt="crash"), OK)],
    "upload_screen": [("off", OK), ("on", OK)],
    "screen_norm_bound": [(10.0, OK)],
    "quarantine_threshold": [(0.5, OK)],
    "quarantine_rounds": [(4, OK)],
    "quarantine_min_tries": [(1, OK)],
    "rng_impl": [("numpy", OK), ("device", OK)],
    "seed": [(3, OK)],
    "selection_seed": [(7, OK)],
    "eval_every": [(2, OK)],
    "model": [("mlp", OK), ("lstm", OK)],
    "compute": [(TCompute(driver="scan", block_size=8), OK)],
    "comm": [(TComm(upload_compress="topk_q8", topk_frac=0.2), OK)],
    "robustness": [(TRobustness(upload_screen="on",
                                screen_norm_bound=10.0), OK)],
}

#: fl_train flag -> [(non-default value or None for a switch, accepted)]
FLAG_CASES = {
    "--dataset": [("synthetic", OK)],
    "--algo": [("fassa", OK)],
    "--rounds": [("3", OK)],
    "--al-rounds": [("2", OK)],
    "--aggregator": [("fedprox", OK)] + [
        (a, OK) for a in ("trimmed_mean", "median", "krum",
                          "geometric_median", "bulyan")],
    "--trim-ratio": [("0.2", OK)],
    "--agg-weighted": [(None, OK)],
    "--n-byzantine": [("1", OK)],
    "--selection": [("active", OK)],
    "--model": [("mlp", OK), ("lstm", OK), ("llama3.2-3b", OK)],
    "--lr": [("0.1", OK)],
    "--sampling": [("iid", OK)],
    "--backend": [("pallas", OK)],
    "--driver": [("scan", OK)],
    "--block-size": [("8", OK)],
    "--shards": [("2", OK)],
    "--cohort-capacity": [("auto", OK), ("4", OK)],
    "--prefetch": [("double_buffer", OK)],
    "--compress": [("topk_q8", OK)],
    "--topk-frac": [("0.2", OK)],
    "--faults": [(m, OK) for m in rfl.FAULT_MODES if m != "none"],
    "--fault-prob": [("0.2", OK)],
    "--fault-seed": [("1", OK)],
    "--explode-factor": [("10", OK)],
    "--dropout-prob": [("0.1", OK)],
    "--availability": [("diurnal", OK)],
    "--day-rounds": [("12", OK)],
    "--duty-cycle": [("0.25", OK)],
    "--straggler": [("pareto", OK)],
    "--pareto-alpha": [("3", OK)],
    "--screen": [("off", OK), ("on", OK)],
    "--screen-norm-bound": [("10", OK)],
    "--quarantine-threshold": [("0.5", OK)],
    "--quarantine-rounds": [("4", OK)],
    "--quarantine-min-tries": [("1", OK)],
    "--checkpoint-dir": [("ckpt", OK)],
    "--checkpoint-every": [("2", OK)],
    "--resume": [(None, OK)],
    "--metrics-out": [("metrics.jsonl", OK)],
    "--trace-dir": [("trace", OK)],
    "--quiet": [(None, OK)],
    "--paper-scale": [(None, OK)],
    "--silo-arch": [("llama3.2-3b", OK)],
    "--silos": [("2", OK)],
    "--max-steps": [("4", OK)],
}

#: the reference's server keywords -> [non-default value] (all accepted)
INIT_CASES = {"sink": [RingBufferSink()], "telemetry": [True, False]}
RUN_CASES = {"checkpoint_dir": ["ckpt"], "checkpoint_every": [2],
             "resume": [True]}

#: the other fields a field needs: quarantine needs the screen and the
#: device rng streams (the reference's checks), the block size and
#: prefetch a scan, a capacity sharding (its one-rank group: ``_group``)
FIELD_CONTEXT = {"quarantine_threshold": dict(upload_screen="on",
                                              rng_impl="device"),
                 "block_size": dict(driver="scan"),
                 "prefetch": dict(driver="scan"),
                 "cohort_capacity": dict(mesh_shards=1)}

#: the ROADMAP item each refused field names (none left)
REFUSED_ITEMS = {}


def _one_round_scan(srv):
    """A scan-driver field, driven one CPU round: one block, one stats
    pull and one eval."""
    srv.run(rounds=1)
    assert len(srv.cohorts) == 1 and srv.host_syncs == 2


def _one_round_device(srv):
    """``rng_impl="device"`` on the host driver: one device round."""
    srv.run(rounds=1)
    assert len(srv.cohorts) == 1 and srv.program is not None


def _one_round_quarantine(srv):
    """Quarantine on: the round's record counts the suspended clients."""
    srv.run(rounds=1)
    assert srv._records.last.quarantined is not None


def _one_round_sharded(srv):
    """Sharding over the one-rank group: this rank holds every client,
    and a capacity below K overflows the rest of the cohort."""
    srv.run(rounds=1)
    assert srv.group is not None and srv.packed.rank == 0
    want = 0 if srv.capacity is None else 4 - min(srv.capacity, 4)
    assert srv._records.last.overflowed == want


def _one_round_group(srv):
    """A group sets its flat twins, and its fields run: the compute
    group's scan driver (one block, one stats pull, one eval), the comm
    group's compression (the residual), the robustness group's screen."""
    cfg = srv.cfg
    for group in ("compute", "comm", "robustness"):
        for f in dataclasses.fields(getattr(cfg, group)):
            assert getattr(getattr(cfg, group), f.name) == \
                getattr(cfg, f.name)
    srv.run(rounds=1)
    rec = srv._records.last
    if cfg.driver == "scan":
        assert cfg.block_size == 8 and srv.host_syncs == 2
    if cfg.upload_compress == "topk_q8":
        assert cfg.topk_frac == 0.2 and srv.residual is not None
    if cfg.upload_screen == "on":
        assert cfg.screen_norm_bound == 10.0 and rec.screened is not None


#: accepted fields driven one CPU round: name -> check(server)
FIELD_RUNS = {"driver": _one_round_scan, "block_size": _one_round_scan,
              "fused_generic": _one_round_scan,
              "rng_impl": _one_round_device,
              "quarantine_threshold": _one_round_quarantine,
              "prefetch": _one_round_scan,
              "mesh_shards": _one_round_sharded,
              "cohort_capacity": _one_round_sharded,
              "compute": _one_round_group, "comm": _one_round_group,
              "robustness": _one_round_group}
FIELD_CONTEXT["fused_generic"] = dict(driver="scan")


class _Captured(Exception):
    pass


def _reference_parser() -> argparse.ArgumentParser:
    """The parser that ``repro.launch.fl_train.main`` builds, caught at its
    ``parse_args`` call."""
    real = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        raise _Captured(self)

    argparse.ArgumentParser.parse_args = capture
    try:
        rfl.main()
    except _Captured as c:
        return c.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("the reference CLI never parsed its flags")


def _flags(parser):
    return {a.option_strings[-1]: a for a in parser._actions
            if a.option_strings and a.dest != "help"}


REF_FLAGS = _flags(_reference_parser())
REF_FIELDS = {f.name: f for f in dataclasses.fields(RConfig)}
DS = dict(n_clients=12, total=300, dim=8, max_size=40)


def _default(f):
    return (f.default_factory() if f.default is dataclasses.MISSING
            else f.default)


def _server(**kw):
    """A CPU server over a small FEMNIST federation (Sent140 for the LSTM,
    which needs tokens)."""
    ds = (make_sent140_like(n_clients=12, total=300, vocab=260, max_size=40)
          if kw.get("model") == "lstm" else make_femnist_like(**DS))
    return TServer(ds, cfg=TConfig(
        **dict(dict(device="cpu", n_selected=4), **kw)))


def test_the_cases_cover_every_reference_option():
    assert set(FIELD_CASES) == set(REF_FIELDS)
    assert set(FLAG_CASES) == set(REF_FLAGS)
    init = inspect.signature(RServer.__init__).parameters
    run = inspect.signature(RServer.run).parameters
    assert set(INIT_CASES) == set(init) - {"self", "dataset", "model",
                                           "cfg", "het"}
    assert set(RUN_CASES) == set(run) - {"self", "rounds", "verbose"}


def _value(cfg, name):
    """A field's value; a group (materialized from the flat fields, in
    both packages) as its fields."""
    value = getattr(cfg, name)
    return (dataclasses.asdict(value) if name in ("compute", "comm",
                                                  "robustness") else value)


@pytest.mark.parametrize("name", sorted(REF_FIELDS))
def test_config_field_accepted_at_reference_default(name):
    default = _default(REF_FIELDS[name])
    assert _value(TConfig(), name) == _value(RConfig(), name)
    srv = _server(**{name: default})
    assert _value(srv.cfg, name) == _value(RConfig(**{name: default}),
                                           name)


@contextlib.contextmanager
def _group(kw):
    """A one-rank gloo group around a sharded server's life (none
    otherwise)."""
    if not kw.get("mesh_shards"):
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("name,value,ok", [
    (n, v, ok) for n, cases in FIELD_CASES.items() for v, ok in cases])
def test_config_field_non_default(name, value, ok):
    kw = dict(FIELD_CONTEXT.get(name, {}), **{name: value})
    if ok:
        with _group(kw):
            srv = _server(**kw)
            assert getattr(srv.cfg, name) == value
            if name in FIELD_RUNS and (name, value) != ("rng_impl", "numpy"):
                FIELD_RUNS[name](srv)
        return
    with pytest.raises((ValueError, NotImplementedError),
                       match=r"ROADMAP " + REFUSED_ITEMS[name]
                       .replace("(", r"\(").replace(")", r"\)")):
        _server(**kw)


@pytest.mark.parametrize("flag", sorted(REF_FLAGS))
def test_flag_accepted_at_reference_default(flag):
    ours = _flags(tfl.make_parser())
    assert flag in ours
    ref = REF_FLAGS[flag]
    assert ours[flag].default == ref.default
    if ref.choices is not None:
        assert set(ref.choices) <= set(ours[flag].choices)
    assert getattr(tfl.parse_args([]), ref.dest) == ref.default
    if ref.nargs != 0 and ref.default is not None:   # spelled out too
        args = tfl.parse_args([flag, str(ref.default)])
        assert getattr(args, ref.dest) == ref.default


def _wrote_records(out):
    """``--metrics-out metrics.jsonl``: a header and one record."""
    meta, records = read_jsonl("metrics.jsonl")
    assert meta["path"] == "flat" and len(records) == 1
    assert "metrics: metrics.jsonl" in out


def _wrote_trace(out):
    """``--trace-dir trace``: a chrome trace with the stage ranges."""
    (path,) = [f for f in os.listdir("trace") if f.endswith(".json")]
    with open(os.path.join("trace", path)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"fed.gather", "fed.local_sgd", "fed.aggregate"} <= names


def _screened(out):
    """``--faults MODE``: the upload screen is on and counts."""
    assert "screened=" in out


def _wrote_checkpoint(out):
    """``--checkpoint-dir ckpt``: the last round's checkpoint."""
    assert [r for r, _ in list_checkpoints("ckpt")] == [1]


def _ran_scan(out):
    """``--driver scan`` / ``--block-size``: the scan driver's round."""
    assert "final: acc=" in out


def _quarantined(out):
    """``--quarantine-threshold``: the screen counts and the quarantine
    reports its suspended clients."""
    assert "screened=" in out and "quarantined=" in out


#: accepted flags whose job one CPU round shows: flag -> check(stdout)
RUN_CHECKS = {"--metrics-out": _wrote_records, "--trace-dir": _wrote_trace,
              "--faults": _screened, "--checkpoint-dir": _wrote_checkpoint,
              "--driver": _ran_scan, "--block-size": _ran_scan,
              "--prefetch": _ran_scan,
              "--quarantine-threshold": _quarantined}
#: the other flags a driven flag needs (``--shards`` spawns its ranks: the
#: CLI run is ``test_torch_sharding.py``'s)
RUN_CONTEXT = {"--block-size": ["--driver", "scan"],
               "--prefetch": ["--driver", "scan"],
               "--quarantine-threshold": ["--driver", "scan", "--faults",
                                          "nan_upload"]}


@pytest.mark.parametrize("flag,value,ok", [
    (f, v, ok) for f, cases in FLAG_CASES.items() for v, ok in cases])
def test_flag_non_default(capsys, monkeypatch, tmp_path, flag, value, ok):
    argv = ["--device", "cpu", flag] + ([] if value is None else [value])
    if ok:
        args = tfl.parse_args(argv)
        assert getattr(args, REF_FLAGS[flag].dest) != \
            REF_FLAGS[flag].default
        if flag in RUN_CHECKS:
            monkeypatch.chdir(tmp_path)
            tfl.main(argv + RUN_CONTEXT.get(flag, [])
                     + ["--rounds", "1", "--quiet"])
            RUN_CHECKS[flag](capsys.readouterr().out)
        return
    with pytest.raises(SystemExit) as exit_:
        tfl.parse_args(argv)
    assert exit_.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(INIT_CASES))
def test_server_keyword_accepted_at_reference_default(name):
    default = inspect.signature(RServer.__init__).parameters[name].default
    TServer(make_femnist_like(**DS), cfg=TConfig(device="cpu"),
            **{name: default})


@pytest.mark.parametrize("name,value", [
    (n, v) for n, values in INIT_CASES.items() for v in values])
def test_server_keyword_non_default(name, value):
    """Each value is accepted and does its job over one round: a sink
    receives the round's record and switches the telemetry extras on,
    ``telemetry=`` switches them on or off."""
    srv = TServer(make_femnist_like(**DS), cfg=TConfig(
        device="cpu", n_selected=4, rounds=1), **{name: value})
    srv.run()
    (rec,) = srv._records.records
    want = value if name == "telemetry" else True
    assert srv.telemetry is want
    assert (rec.loss_hist is not None) is want
    if name == "sink":
        assert value.last is rec


def test_run_keywords_accepted_at_reference_defaults():
    params = inspect.signature(RServer.run).parameters
    srv = _server(rounds=1)
    hist = srv.run(**{n: params[n].default for n in RUN_CASES})
    assert len(hist["acc"]) == 1


@pytest.mark.parametrize("name,value", [
    (n, v) for n, values in RUN_CASES.items() for v in values])
def test_run_keyword_non_default(monkeypatch, tmp_path, name, value):
    """Each checkpoint keyword does its job on the CPU:
    ``checkpoint_dir`` saves the last round, ``checkpoint_every`` adds
    every n-th, ``resume`` continues from the latest checkpoint (and
    needs ``checkpoint_dir``)."""
    monkeypatch.chdir(tmp_path)
    if name == "resume":
        with pytest.raises(ValueError, match="requires checkpoint_dir"):
            _server(rounds=1).run(resume=value)
        _server(rounds=3).run(rounds=1, checkpoint_dir="ckpt")
        srv = _server(rounds=3)
        hist = srv.run(checkpoint_dir="ckpt", resume=value)
        assert len(hist["acc"]) == 3
        assert [r for r, _ in list_checkpoints("ckpt")] == [1, 3]
        return
    kw = {name: value}
    if name == "checkpoint_every":
        kw["checkpoint_dir"] = "ckpt"
    _server(rounds=3).run(**kw)
    want = [2, 3] if name == "checkpoint_every" else [3]
    assert [r for r, _ in list_checkpoints(value if name == "checkpoint_dir"
                                           else "ckpt")] == want
