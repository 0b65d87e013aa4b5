"""The paper's experiments on the port (``repro_torch.experiments``) against
the reference, on the CPU.

Per run: the reference's ``FedSAEServer`` with the config its
``benchmarks/common.py:58-71`` builds (written out here: no module of
``benchmarks/`` is imported), its init and threefry shuffle draws
injected into the twin's ``make_server`` through ``init_params=`` and
``data_draws=``.  Cohorts, dropout, assigned, uploaded and true workload
bitwise; train and test loss within 2e-5; accuracy and ``final_acc``
within 2/test_n.  Then each figure's runner at 2 rounds prints the
reference's CSV lines character for character (rebuilt here from its JSON
with the reference's format strings) and writes the reference's JSON
keys; the helpers on hand-made histories; the runner's refusal without a
card; the two example twins in a subprocess.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import FedSAEServer as JServer
from repro.core import HeterogeneitySim as JHet
from repro.core import ServerConfig as JConfig
from repro.data import federated as jfed
from repro.models import fl_models as jfl
from repro_torch.experiments import (common, fig1_motivation, fig5_u_sweep,
                                     fig6_table2_main, fig7_fassa_params,
                                     fig8_table3_al)
from repro_torch.experiments import run as exp_run
from torch_cases import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 2e-5

# the reference's reduced sizes (benchmarks/common.py:42-55) and paper
# learning rates / cohort sizes (:26-27)
REDUCED = {
    "femnist": (jfed.make_femnist_like, dict(n_clients=60, total=4500,
                                             dim=64, max_size=120)),
    "mnist": (jfed.make_mnist_like, dict(n_clients=100, total=7000, dim=64,
                                         max_size=120, sep=0.8, noise=2.2)),
    "sent140": (jfed.make_sent140_like, dict(n_clients=60, total=1800,
                                             vocab=300, max_size=50)),
    "synthetic": (jfed.make_synthetic, dict(n_clients=40, total=3000,
                                            max_size=150)),
}
LR = {"femnist": 0.03, "mnist": 0.03, "sent140": 0.3, "synthetic": 0.01}
K = {"femnist": 10, "mnist": 30, "sent140": 10, "synthetic": 10}

PAYLOAD_KEYS = {"algo", "dataset", "rounds", "final_acc", "mean_dropout",
                "late_dropout", "wall_s", "history", "config"}


def _reference_draws(seed, T, max_n):
    """The shuffle sort keys of the reference's host driver: data_rng, sub
    = split(data_rng) each round, then one uniform [max_n] per client."""
    subs, key = [], jax.random.PRNGKey(seed)
    for _ in range(T):
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draws(t, ids, n):
        keys = jax.random.split(subs[t], len(ids))
        return np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (max_n,)))(keys))

    return draws


def _reference_run(name, algo, rounds, init_shift=False, **kw):
    """The reference's run_server, written out: (server, init, history,
    config).  ``init_shift`` moves every init value up by one ulp."""
    make, dkw = REDUCED[name]
    ds = make(**dkw)
    if name == "sent140":
        model = jfl.make_lstm(vocab=ds.clients_x[0].max() + 200)
    else:
        model = jfl.make_mclr(ds.clients_x[0].shape[1], ds.n_classes)
    config = dict(algo=algo, rounds=rounds,
                  n_selected=min(K[name], ds.n_clients), lr=LR[name],
                  h_cap=24.0, eval_every=max(1, rounds // 40), seed=0)
    config.update(kw)
    srv = JServer(ds, model, JConfig(**config),
                  het=JHet(ds.n_clients, seed=0))
    if init_shift:
        srv.params = jax.tree.map(lambda p: np.nextafter(
            np.asarray(p), np.float32(np.inf)), srv.params)
    init = jax.tree.map(np.asarray, srv.params)
    return srv, init, srv.run(), config


def _nan(values):
    return np.array([np.nan if v is None else v for v in values],
                    np.float64)


# (dataset, algo, rounds, knobs, rounds whose losses and accuracy are
# held).  At the paper's Sent140 lr of 0.3 the LSTM's local SGD grows
# float32 rounding by orders of magnitude a round: the reference against
# itself, its init moved one ulp, leaves 2e-5 by the third round (asserted
# below).  There the first round's values are held, with the cohorts and
# workloads over all three, and the same run at lr 0.03 on every round
CASES = [
    ("femnist", "fedavg", 3, dict(fixed_epochs=12.0), 3),
    ("femnist", "ira", 3, dict(U=2.0), 3),
    ("mnist", "fassa", 3, dict(gamma1=5.0, alpha=0.5), 3),
    ("femnist", "ira", 4, dict(al_rounds=2, eval_every=1), 4),
    ("synthetic", "oracle", 3, {}, 3),
    ("sent140", "fedprox", 3, {}, 1),
    ("sent140", "fedprox", 3, dict(lr=0.03), 3),
]


@pytest.mark.parametrize("name,algo,rounds,kw,held", CASES,
                         ids=[f"{c[0]}-{c[1]}-{'-'.join(c[3]) or 'default'}"
                              for c in CASES])
def test_run_matches_reference(name, algo, rounds, kw, held):
    jsrv, init, jhist, jconfig = _reference_run(name, algo, rounds, **kw)
    ds, model = common.build_dataset(name, "reduced")
    np.testing.assert_array_equal(ds.sizes, jsrv.ds.sizes)
    srv, config = common.make_server(
        ds, model, algo, rounds, name, device="cpu", init_params=init,
        data_draws=_reference_draws(0, rounds, int(ds.sizes.max())), **kw)
    assert srv.max_iters == jsrv.max_iters
    assert config == jconfig
    payload = common.run_made(srv, config, name)

    assert set(payload) == PAYLOAD_KEYS
    assert (payload["algo"], payload["dataset"], payload["rounds"]) == (
        algo, name, rounds)
    assert payload["config"] == jconfig
    assert len(srv.cohorts) == len(jsrv.cohorts) == rounds
    for a, b in zip(srv.cohorts, jsrv.cohorts):
        np.testing.assert_array_equal(a, b)
    hist = payload["history"]
    assert list(hist) == list(jhist)
    for k in ("dropout", "assigned", "uploaded", "true_workload"):
        np.testing.assert_array_equal(hist[k], jhist[k])
    assert payload["mean_dropout"] == float(np.nanmean(jhist["dropout"]))
    assert payload["late_dropout"] == float(
        np.nanmean(jhist["dropout"][rounds // 2:]))
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(_nan(hist[k][:held]),
                                   np.asarray(jhist[k][:held]), rtol=TOL,
                                   atol=TOL)
    acc_tol = 2.0 / len(ds.test_y)
    assert np.max(np.abs(_nan(hist["acc"][:held])
                         - np.asarray(jhist["acc"][:held]))) <= acc_tol
    if held == rounds:
        assert abs(payload["final_acc"] - float(
            np.nanmax(jhist["acc"][-5:]))) <= acc_tol
    else:
        # the rounds not held: the reference's own one-ulp twin leaves 2e-5
        twin = _reference_run(name, algo, rounds, init_shift=True, **kw)[2]
        assert abs(twin["train_loss"][-1] - jhist["train_loss"][-1]) > TOL
    json.dumps(payload)              # NaN written as None: plain JSON


def _csv_lines(suite, data):
    """The reference's CSV lines, from the runner's JSON, with the
    reference's format strings."""
    if suite == "fig1_motivation":
        return [f"fig1,{r['dataset']},E={r['fixed_epochs']},"
                f"acc={r['final_acc']:.3f},dropout={r['mean_dropout']:.3f}"
                for r in data]
    if suite == "fig5_u_sweep":
        return [f"fig5,{r['dataset']},U={r['U']},acc={r['final_acc']:.3f},"
                f"dropout={r['mean_dropout']:.3f}" for r in data]
    if suite == "fig6_table2_main":
        lines = [f"table2,{r['dataset']},{r['algo']},"
                 f"acc={r['final_acc']:.3f},"
                 f"stragglers={r['mean_dropout']*100:.1f}%"
                 for r in data["results"]]
        return lines + [
            f"table2,AVERAGE,acc_gain={data['avg_acc_gain']*100:.1f}pp,"
            f"straggler_reduction="
            f"{data['avg_straggler_reduction']*100:.1f}pp"]
    if suite == "fig7_fassa_params":
        return [f"fig7,{r['dataset']},g1={r['gamma1']},g2={r['gamma2']},"
                f"a={r['alpha']},acc={r['final_acc']:.3f},"
                f"dropout={r['mean_dropout']:.3f}" for r in data]
    target = fig8_table3_al.TARGET_ACC["reduced"]
    return [f"table3,{r['dataset']},AL{r['al_rounds']},"
            f"to_{target[r['dataset']]:.0%}={r['rounds_to_target']},"
            f"final={r['final_acc']:.3f}" for r in data]


EXTRA_KEYS = {"fig1_motivation": {"fixed_epochs"}, "fig5_u_sweep": {"U"},
              "fig7_fassa_params": {"gamma1", "gamma2", "alpha"},
              "fig8_table3_al": {"al_rounds", "rounds_to_target"}}
SUITES = {"fig1_motivation": (fig1_motivation, 8),
          "fig5_u_sweep": (fig5_u_sweep, 8),
          "fig6_table2_main": (fig6_table2_main, 20),
          "fig7_fassa_params": (fig7_fassa_params, 12),
          "fig8_table3_al": (fig8_table3_al, 10)}


@pytest.mark.parametrize("suite", list(SUITES))
def test_figure_runner_prints_and_writes_the_reference_format(
        suite, tmp_path, capsys):
    mod, n_runs = SUITES[suite]
    mod.run("reduced", rounds=2, device="cpu", out_dir=str(tmp_path))
    printed = capsys.readouterr().out.strip().splitlines()
    with open(tmp_path / f"{suite}.json") as f:
        data = json.load(f)
    assert printed == _csv_lines(suite, data)
    if suite == "fig6_table2_main":
        assert set(data) == {"results", "summary", "avg_acc_gain",
                             "avg_straggler_reduction"}
        runs = data["results"]
        assert set(data["summary"]) == {
            f"{d}/{a}" for d in fig6_table2_main.DATASETS
            for a in ("ira", "fassa")}
        for v in data["summary"].values():
            assert set(v) == {"acc_gain", "straggler_reduction"}
    else:
        runs = data
    assert len(runs) == n_runs
    for r in runs:
        assert set(r) == PAYLOAD_KEYS | EXTRA_KEYS.get(suite, set())
        assert r["rounds"] == 2 and math.isfinite(r["final_acc"])
        assert r["config"]["eval_every"] == (
            1 if suite == "fig8_table3_al" else max(1, 2 // 40))
        assert all(len(v) == 2 for v in r["history"].values())


def test_rounds_to_target():
    f = fig8_table3_al.rounds_to_target
    assert f({"acc": [0.1, None, float("nan"), 0.7, 0.95]}, 0.7) == 4
    assert f({"acc": [None, 0.9]}, 0.9) == 2
    assert f({"acc": [0.1, 0.2, float("nan")]}, 0.5) is None
    assert f({"acc": []}, 0.5) is None
    assert fig8_table3_al.al_grid(40) == [0, 4, 10, 20, 40]
    assert fig8_table3_al.al_grid(2) == [0, 0, 0, 1, 2]


def test_table2_summary_and_average():
    acc = {"fedavg": 0.5, "ira": 0.75, "fassa": 0.8}
    drop = {"fedavg": 0.9, "ira": 0.2, "fassa": 0.1}
    table = {}
    for i, d in enumerate(fig6_table2_main.DATASETS):
        for a in acc:
            table[(d, a)] = {"final_acc": acc[a] + 0.01 * i,
                             "mean_dropout": drop[a] - 0.1 * i * (a != "ira")}
    summary = fig6_table2_main.summarize(table)
    assert list(summary) == [f"{d}/{a}" for d in fig6_table2_main.DATASETS
                             for a in ("ira", "fassa")]
    for i, d in enumerate(fig6_table2_main.DATASETS):
        assert summary[f"{d}/ira"]["acc_gain"] == pytest.approx(0.25)
        assert summary[f"{d}/fassa"]["acc_gain"] == pytest.approx(0.3)
        assert summary[f"{d}/ira"]["straggler_reduction"] == pytest.approx(
            0.7 - 0.1 * i)
        assert summary[f"{d}/fassa"]["straggler_reduction"] == \
            pytest.approx(0.8)
    gains = [v["acc_gain"] for v in summary.values()]
    reds = [v["straggler_reduction"] for v in summary.values()]
    assert np.mean(gains) == pytest.approx(0.275)
    assert np.mean(reds) == pytest.approx((0.7 + 0.6 + 0.5 + 0.4) / 8
                                          + 0.8 / 2)


def test_build_dataset_keeps_the_reference_sizes():
    for name, (make, dkw) in REDUCED.items():
        ds, model = common.build_dataset(name, "reduced")
        ref = make(**dkw)
        np.testing.assert_array_equal(ds.sizes, ref.sizes)
        np.testing.assert_array_equal(ds.clients_x[0], ref.clients_x[0])
        assert model.name == ("lstm" if name == "sent140" else "mclr")
    make, dkw = REDUCED["sent140"]
    _, lstm = common.build_dataset("sent140", "reduced")
    emb = lstm.init_params(torch.Generator().manual_seed(0))["emb"]
    assert emb.shape[0] == int(make(**dkw).clients_x[0].max()) + 200
    assert common.default_rounds("paper") == 200
    assert common.default_rounds("reduced") == 40


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine with no card")
def test_runner_refuses_without_a_card_and_runs_on_cpu(tmp_path, capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_run.main(["--rounds", "2", "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fig5_u_sweep.run("reduced", 2, out_dir=str(tmp_path))
    assert not os.listdir(tmp_path)
    exp_run.main(["--device", "cpu", "--rounds", "2", "--only", "fig5",
                  "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "== fig5_u_sweep ==" in out and "experiments done in" in out
    assert os.listdir(tmp_path) == ["fig5_u_sweep.json"]


@pytest.mark.parametrize("script,args,last", [
    ("quickstart_torch.py", [], "ira    : accuracy="),
    ("paper_scale_fl_torch.py", ["--rounds", "2", "--clients", "100"],
     "paper reference (real MNIST, Table II)")])
def test_example_twin_runs_on_cpu(script, args, last):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *args,
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith(last)
