"""Every option of the reference's federated surface is accepted by the
port at the reference's default, and every value the port does not run
fails with a message that names its ROADMAP item.

The options are enumerated from the reference itself: the fields of
``repro.core.server.ServerConfig``, the flags of the ``repro.launch.fl_train``
parser, and the keyword arguments of ``FedSAEServer.__init__`` and
``FedSAEServer.run``.  Each non-default value below is either one the port
supports (it must be accepted) or one it refuses (``ValueError`` or
``NotImplementedError`` from the server, ``SystemExit`` from argparse, with
"ROADMAP" in the message).
"""
import argparse
import dataclasses
import inspect

import pytest

import repro.launch.fl_train as rfl
from repro.core.server import CommConfig as RComm
from repro.core.server import ComputeConfig as RCompute
from repro.core.server import FedSAEServer as RServer
from repro.core.server import RobustnessConfig as RRobustness
from repro.core.server import ServerConfig as RConfig
from repro.faults import FaultModel
from repro_torch.core.server import FedSAEServer as TServer
from repro_torch.core.server import ServerConfig as TConfig
from repro_torch.data.federated import make_femnist_like
from repro_torch.launch import fl_train as tfl

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
    "aggregator": [("fedprox", OK), ("trimmed_mean", REFUSED),
                   ("median", REFUSED)],
    "trim_ratio": [(0.2, REFUSED)],
    "selection": [("active", OK), ("loss_proportional", OK)],
    "sampling": [("iid", OK)],
    "backend": [("pallas", OK)],
    "driver": [("scan", REFUSED)],
    "block_size": [(8, REFUSED)],
    "mesh_shards": [(2, REFUSED)],
    "cohort_capacity": [("auto", REFUSED), (4, REFUSED)],
    "prefetch": [("double_buffer", REFUSED)],
    "fused_generic": [(False, REFUSED)],
    "upload_compress": [("topk_q8", OK)],
    "topk_frac": [(0.2, OK)],
    "agg_weighted": [(True, REFUSED)],
    "n_byzantine": [(1, REFUSED)],
    "faults": [(FaultModel(corrupt="crash"), REFUSED)],
    "upload_screen": [("off", OK), ("on", REFUSED)],
    "screen_norm_bound": [(10.0, REFUSED)],
    "quarantine_threshold": [(0.5, REFUSED)],
    "quarantine_rounds": [(4, REFUSED)],
    "quarantine_min_tries": [(1, REFUSED)],
    "rng_impl": [("numpy", OK), ("device", REFUSED)],
    "seed": [(3, OK)],
    "selection_seed": [(7, OK)],
    "eval_every": [(2, OK)],
    "model": [("mlp", OK), ("lstm", REFUSED)],
    "compute": [(RCompute(), REFUSED)],
    "comm": [(RComm(), REFUSED)],
    "robustness": [(RRobustness(), REFUSED)],
}

#: fl_train flag -> [(non-default value or None for a switch, accepted)]
FLAG_CASES = {
    "--dataset": [("synthetic", OK)],
    "--algo": [("fassa", OK)],
    "--rounds": [("3", OK)],
    "--al-rounds": [("2", OK)],
    "--aggregator": [("fedprox", OK)] + [
        (a, REFUSED) for a in ("trimmed_mean", "median", "krum",
                               "geometric_median", "bulyan")],
    "--trim-ratio": [("0.2", REFUSED)],
    "--agg-weighted": [(None, REFUSED)],
    "--n-byzantine": [("1", REFUSED)],
    "--selection": [("active", OK)],
    "--model": [("mlp", OK), ("lstm", REFUSED), ("llama3.2-3b", REFUSED)],
    "--lr": [("0.1", OK)],
    "--sampling": [("iid", OK)],
    "--backend": [("pallas", OK)],
    "--driver": [("scan", REFUSED)],
    "--block-size": [("8", REFUSED)],
    "--shards": [("2", REFUSED)],
    "--cohort-capacity": [("auto", REFUSED), ("4", REFUSED)],
    "--prefetch": [("double_buffer", REFUSED)],
    "--compress": [("topk_q8", OK)],
    "--topk-frac": [("0.2", OK)],
    "--faults": [(m, REFUSED) for m in rfl.FAULT_MODES if m != "none"],
    "--fault-prob": [("0.2", REFUSED)],
    "--fault-seed": [("1", REFUSED)],
    "--explode-factor": [("10", REFUSED)],
    "--dropout-prob": [("0.1", REFUSED)],
    "--availability": [("diurnal", REFUSED)],
    "--day-rounds": [("12", REFUSED)],
    "--duty-cycle": [("0.25", REFUSED)],
    "--straggler": [("pareto", REFUSED)],
    "--pareto-alpha": [("3", REFUSED)],
    "--screen": [("off", OK), ("on", REFUSED)],
    "--screen-norm-bound": [("10", REFUSED)],
    "--quarantine-threshold": [("0.5", REFUSED)],
    "--quarantine-rounds": [("4", REFUSED)],
    "--quarantine-min-tries": [("1", REFUSED)],
    "--checkpoint-dir": [("ckpt", REFUSED)],
    "--checkpoint-every": [("2", REFUSED)],
    "--resume": [(None, REFUSED)],
    "--metrics-out": [("metrics.jsonl", REFUSED)],
    "--trace-dir": [("trace", REFUSED)],
    "--quiet": [(None, OK)],
    "--paper-scale": [(None, OK)],
    "--silo-arch": [("llama3.2-3b", OK)],
    "--silos": [("2", OK)],
    "--max-steps": [("4", OK)],
}

#: the reference's server keywords -> [(non-default value, ROADMAP item)]
INIT_CASES = {"sink": [(object(), "A10")], "telemetry": [(True, "A10"),
                                                          (False, "A10")]}
RUN_CASES = {"checkpoint_dir": [("ckpt", "A11")],
             "checkpoint_every": [(2, "A11")], "resume": [(True, "A11")]}


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
    return TServer(make_femnist_like(**DS), cfg=TConfig(
        **dict(dict(device="cpu", n_selected=4), **kw)))


def test_the_cases_cover_every_reference_option():
    assert set(FIELD_CASES) == set(REF_FIELDS)
    assert set(FLAG_CASES) == set(REF_FLAGS)
    init = inspect.signature(RServer.__init__).parameters
    run = inspect.signature(RServer.run).parameters
    assert set(INIT_CASES) == set(init) - {"self", "dataset", "model",
                                           "cfg", "het"}
    assert set(RUN_CASES) == set(run) - {"self", "rounds", "verbose"}


@pytest.mark.parametrize("name", sorted(REF_FIELDS))
def test_config_field_accepted_at_reference_default(name):
    default = _default(REF_FIELDS[name])
    assert getattr(TConfig(), name) == default
    srv = _server(**{name: default})
    assert getattr(srv.cfg, name) == default


@pytest.mark.parametrize("name,value,ok", [
    (n, v, ok) for n, cases in FIELD_CASES.items() for v, ok in cases])
def test_config_field_non_default(name, value, ok):
    if ok:
        assert getattr(_server(**{name: value}).cfg, name) == value
        return
    with pytest.raises((ValueError, NotImplementedError), match="ROADMAP"):
        _server(**{name: value})


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


@pytest.mark.parametrize("flag,value,ok", [
    (f, v, ok) for f, cases in FLAG_CASES.items() for v, ok in cases])
def test_flag_non_default(capsys, flag, value, ok):
    argv = ["--device", "cpu", flag] + ([] if value is None else [value])
    if ok:
        args = tfl.parse_args(argv)
        assert getattr(args, REF_FLAGS[flag].dest) != \
            REF_FLAGS[flag].default
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


@pytest.mark.parametrize("name,value,item", [
    (n, v, i) for n, cases in INIT_CASES.items() for v, i in cases])
def test_server_keyword_non_default(name, value, item):
    with pytest.raises(ValueError, match=f"ROADMAP {item}"):
        TServer(make_femnist_like(**DS), cfg=TConfig(device="cpu"),
                **{name: value})


def test_run_keywords_accepted_at_reference_defaults():
    params = inspect.signature(RServer.run).parameters
    srv = _server(rounds=1)
    hist = srv.run(**{n: params[n].default for n in RUN_CASES})
    assert len(hist["acc"]) == 1


@pytest.mark.parametrize("name,value,item", [
    (n, v, i) for n, cases in RUN_CASES.items() for v, i in cases])
def test_run_keyword_non_default(name, value, item):
    srv = _server(rounds=1)
    with pytest.raises(ValueError, match=f"ROADMAP {item}"):
        srv.run(**{name: value})
    assert srv.history["acc"] == []
