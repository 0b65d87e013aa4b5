"""Port server algebra and host driver against the reference.

Bitwise: Ira/Fassa/outcomes (numpy float64 copies), HeterogeneitySim draws
and the selection strategies given equal numpy generators, and — over
three host rounds with ``selection="random"`` — cohorts and L/H/theta.
Within 2e-5: params and losses (local SGD sums in another order).  Test
accuracy within 2/test_n: a sample on the decision boundary may flip.
Without injected draws, final accuracy within a 0.03 band.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prediction as jpred
from repro.core import selection as jsel
from repro.core.heterogeneity import HeterogeneitySim as JHet
from repro.core.server import FedSAEServer as JServer
from repro.core.server import ServerConfig as JConfig
from repro.data import federated as jfed
from repro.data.federated import make_femnist_like as jfemnist
from repro.models.fl_models import resolve_local_step as jresolve
from repro_torch.core import prediction as tpred
from repro_torch.core import selection as tsel
from repro_torch.core.heterogeneity import HeterogeneitySim as THet
from repro_torch.core.server import (CommConfig, ComputeConfig,
                                     RobustnessConfig)
from repro_torch.core.server import FedSAEServer as TServer
from repro_torch.core.server import HISTORY_KEYS
from repro_torch.core.server import ServerConfig as TConfig
from repro_torch.data import federated as tfed
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.faults import FaultModel
from repro_torch.launch import fl_train
from repro_torch.models.fl_models import resolve_local_step
from torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-5


def _pairs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    L = rng.uniform(0.25, 10, n)
    H = L + rng.uniform(0.001, 8, n)
    E = np.r_[rng.uniform(0, 20, n - 4), L[-4:-2], H[-2:]]   # ties on bounds
    theta = rng.uniform(0, 15, n)
    return L, H, E, theta


def test_prediction_bitwise():
    L, H, E, theta = _pairs()
    np.testing.assert_array_equal(tpred.outcomes(L, H, E),
                                  jpred.outcomes(L, H, E))
    np.testing.assert_array_equal(tpred.uploaded_epochs(L, H, E),
                                  jpred.uploaded_epochs(L, H, E))
    for h_cap in (0.0, 24.0):
        for a, b in zip(tpred.ira_predict(L, H, E, U=10.0, h_cap=h_cap),
                        jpred.ira_predict(L, H, E, U=10.0, h_cap=h_cap)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(
                tpred.fassa_predict(L, H, E, theta, 3.0, 1.0, h_cap=h_cap),
                jpred.fassa_predict(L, H, E, theta, 3.0, 1.0, h_cap=h_cap)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpred.fassa_threshold(theta, E, 0.95),
                                  jpred.fassa_threshold(theta, E, 0.95))
    assert (tpred.COMPLETED_H, tpred.COMPLETED_L, tpred.DROPPED) == (
        jpred.COMPLETED_H, jpred.COMPLETED_L, jpred.DROPPED)


def test_heterogeneity_draws_bitwise():
    a, b = THet(50, seed=3), JHet(50, seed=3)
    np.testing.assert_array_equal(a.mu, b.mu)
    np.testing.assert_array_equal(a.sigma, b.sigma)
    for _ in range(3):
        np.testing.assert_array_equal(a.sample_round(), b.sample_round())


@pytest.mark.parametrize("name", ["random", "active", "loss_proportional"])
def test_selection_bitwise(name):
    v = np.random.default_rng(1).uniform(0, 40, 30)
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        np.testing.assert_array_equal(
            tsel.get_selection(name)(ra, v, 30, 5, 0.01),
            jsel.get_selection(name)(rb, v, 30, 5, 0.01))
    np.testing.assert_array_equal(tsel.selection_probs(v, 0.05),
                                  jsel.selection_probs(v, 0.05))
    sizes = np.arange(1, 31, dtype=np.float64)
    ta, tb = tsel.ValueTracker(30, sizes), jsel.ValueTracker(30, sizes)
    for t in (ta, tb):
        t.update([3, 7], [0.5, 1.25])
        t.update([], [])
    np.testing.assert_array_equal(ta.v, tb.v)


DS_KW = dict(n_clients=20, total=600, dim=16, max_size=24)
CFG_KW = dict(n_selected=5, lr=0.05, batch_size=4, rounds=3, h_cap=6.0,
              fixed_epochs=4.0, selection="random")


def _reference_draws(seed, T, max_iters, B, max_n, sampling):
    """Per-round minibatch draws exactly as the reference's host driver
    makes them: data_rng, sub = split(data_rng) each round, then the
    round's per-client keys and randint/uniform calls."""
    subs, key = [], jax.random.PRNGKey(seed)
    for _ in range(T):
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draws(t, ids, n):
        keys = jax.random.split(subs[t], len(ids))
        if sampling == "iid":
            return np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
                k, (max_iters, B), 0, jnp.maximum(nk, 1)))(
                keys, jnp.asarray(n, jnp.int32)))
        return np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (max_n,)))(keys))

    return draws


@pytest.mark.parametrize("algo,sampling", [("ira", "iid"),
                                           ("fassa", "shuffle"),
                                           ("fedprox", "iid")])
def test_three_host_rounds_match_reference(algo, sampling):
    jcfg = JConfig(algo=algo, sampling=sampling, **CFG_KW)
    jsrv = JServer(jfemnist(**DS_KW), cfg=jcfg)
    init = jax.tree.map(np.asarray, jsrv.params)
    jhist = jsrv.run()

    tds = tfemnist(**DS_KW)
    tcfg = TConfig(algo=algo, sampling=sampling, device="cpu", **CFG_KW)
    max_n = int(tds.sizes.max())
    tsrv = TServer(tds, cfg=tcfg, init_params=init,
                   data_draws=_reference_draws(
                       0, 3, jsrv.max_iters, 4, max_n, sampling))
    assert tsrv.max_iters == jsrv.max_iters
    thist = tsrv.run()

    for a, b in zip(tsrv.cohorts, jsrv.cohorts):
        np.testing.assert_array_equal(a, b)
    for name in ("L", "H", "theta"):
        np.testing.assert_array_equal(getattr(tsrv, name),
                                      getattr(jsrv, name))
    for k in init:
        np.testing.assert_allclose(tsrv.params[k].numpy(),
                                   np.asarray(jsrv.params[k]),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tsrv.values.v, jsrv.values.v, rtol=TOL,
                               atol=TOL)
    assert list(thist) == list(HISTORY_KEYS) == list(jhist)
    for k in ("dropout", "assigned", "uploaded", "true_workload",
              "overflowed", "dropped"):
        np.testing.assert_array_equal(thist[k], jhist[k])
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(thist["test_loss"], jhist["test_loss"],
                               rtol=TOL, atol=TOL)
    test_n = len(tds.test_y)
    assert np.max(np.abs(np.subtract(thist["acc"], jhist["acc"]))) \
        <= 2.0 / test_n


def test_three_compressed_mlp_host_rounds_match_reference():
    """model="mlp", sampling="iid", upload_compress="topk_q8": cohorts and
    L/H/theta bitwise, losses within 2e-5; the residual is the [N, P]
    state the reference keeps, zero for never-uploading clients."""
    kw = dict(CFG_KW, model="mlp", sampling="iid",
              upload_compress="topk_q8", topk_frac=0.1)
    jsrv = JServer(jfemnist(**DS_KW), cfg=JConfig(algo="ira", **kw))
    init = jax.tree.map(np.asarray, jsrv.params)
    jhist = jsrv.run()
    tds = tfemnist(**DS_KW)
    tsrv = TServer(tds, cfg=TConfig(algo="ira", device="cpu", **kw),
                   init_params=init,
                   data_draws=_reference_draws(0, 3, jsrv.max_iters, 4,
                                               int(tds.sizes.max()), "iid"))
    thist = tsrv.run()
    for a, b in zip(tsrv.cohorts, jsrv.cohorts):
        np.testing.assert_array_equal(a, b)
    for name in ("L", "H", "theta"):
        np.testing.assert_array_equal(getattr(tsrv, name),
                                      getattr(jsrv, name))
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                               rtol=TOL, atol=TOL)
    assert tsrv.residual.shape == jsrv.residual.shape
    assert tsrv.residual.dtype == torch.float32
    touched = np.unique(np.concatenate(tsrv.cohorts))
    rest = np.setdiff1d(np.arange(tds.n_clients), touched)
    assert not tsrv.residual.numpy()[rest].any()
    assert np.isfinite(tsrv.residual.numpy()).all()
    assert tsrv.residual.numpy()[touched].any()
    assert (tsrv.bytes_per_client, tsrv.dense_bytes_per_client) == (
        jsrv._bytes_per_client, jsrv._dense_bytes_per_client)


def test_uncompressed_server_keeps_no_residual():
    srv = TServer(tfemnist(**DS_KW), cfg=TConfig(device="cpu", **CFG_KW))
    assert srv.residual is None
    assert srv.bytes_per_client == srv.dense_bytes_per_client


@pytest.mark.parametrize("extra", [
    [], ["--model", "mlp", "--sampling", "iid", "--compress", "topk_q8"]])
def test_cli_smoke_on_cpu(capsys, extra):
    hist = fl_train.main(["--device", "cpu", "--rounds", "2", "--quiet"]
                         + extra)
    assert len(hist["acc"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert "final: acc=" in capsys.readouterr().out


#: the error each A12 (ii) value (ported: sharding, capacity, prefetch)
#: raises, as the reference's, in a config that cannot run it: sharding
#: without a process group, capacity without sharding, prefetch on a mesh;
#: and each A15 group (ported) in a config whose explicit flat twin
#: conflicts with it (the reference's ValueError, naming the field)
MISUSE = {"mesh_shards": ({}, "needs a torch.distributed default "
                              "process group"),
          "cohort_capacity": ({}, "requires mesh sharding"),
          "prefetch": (dict(driver="scan", mesh_shards=1),
                       "not supported on a sharded mesh"),
          "compute": (dict(block_size=8), "block_size=8 conflicts with "
                                          "compute.block_size=4"),
          "comm": (dict(topk_frac=0.3), "topk_frac=0.3 conflicts with "
                                        "comm.topk_frac=0.2"),
          "robustness": ({}, "upload_screen='on' conflicts with "
                             "robustness.upload_screen='off'")}


@pytest.mark.parametrize("field,value,item", [
    ("mesh_shards", 2, "A12"), ("cohort_capacity", "auto", "A12"),
    ("prefetch", "double_buffer", "A12"),
    ("compute", ComputeConfig(block_size=4), "A15"),
    ("comm", CommConfig(topk_frac=0.2), "A15"),
    ("robustness", RobustnessConfig(upload_screen="off"), "A15")])
def test_unported_config_raises(field, value, item):
    """The A12 (ii) options and the A15 groups are ported: each raises the
    reference's error where it cannot run (``MISUSE``)."""
    extra, match = MISUSE[field]
    with pytest.raises(ValueError, match=match):
        TServer(tfemnist(**DS_KW), cfg=TConfig(
            device="cpu", upload_screen="on", **extra, **{field: value}))


@pytest.mark.parametrize("field,value", [
    ("driver", "scan"), ("rng_impl", "device"),
    ("quarantine_threshold", 0.5)])
def test_device_driver_config_accepted(field, value):
    """The device drivers' options run a CPU round (quarantine with the
    screen on and the device rng streams, as the reference requires)."""
    kw = {field: value}
    if field == "quarantine_threshold":
        kw["rng_impl"] = "device"
    srv = TServer(tfemnist(**DS_KW), cfg=TConfig(
        device="cpu", upload_screen="on", **dict(CFG_KW, **kw)))
    hist = srv.run(rounds=2)
    assert len(hist["acc"]) == 2 and srv.rng_impl == "device"


@pytest.mark.parametrize("field,value,item", [
    ("mesh_shards", 2, "A12"), ("cohort_capacity", "auto", "A12"),
    ("prefetch", "double_buffer", "A12")])
def test_compression_with_an_unported_feature_raises(field, value, item):
    """Compression with the A12 (ii) options, once refused by item: the
    config is accepted, and the server raises the reference's error where
    the combination cannot run (``MISUSE``)."""
    extra, match = MISUSE[field]
    cfg = TConfig(device="cpu", upload_compress="topk_q8", **extra,
                  **{field: value})
    assert getattr(cfg, field) == value
    with pytest.raises(ValueError, match=match):
        TServer(tfemnist(**DS_KW), cfg=cfg)


@pytest.mark.parametrize("kw", [
    dict(faults=FaultModel(seed=1, corrupt="nan", corrupt_prob=0.5)),
    dict(upload_screen="on"),
    dict(upload_screen="off",
         faults=FaultModel(seed=1, corrupt="crash", corrupt_prob=0.5)),
    dict(upload_compress="topk_q8", model="mlp", sampling="iid",
         faults=FaultModel(seed=1, corrupt="explode", corrupt_prob=0.5))],
    ids=["faults", "screen-on", "screen-off", "faults-topk_q8"])
def test_fault_options_run(kw):
    """The fault model and the screen (once refused, ROADMAP A9) run a
    CPU round: the screen's count is in the record exactly when it is on,
    and the params stay finite."""
    srv = TServer(tfemnist(**DS_KW), cfg=TConfig(
        device="cpu", **dict(CFG_KW, rounds=2), **kw))
    srv.run()
    screening = kw.get("upload_screen", "auto") == "on" or (
        kw.get("upload_screen", "auto") == "auto" and "faults" in kw)
    assert srv.screening is screening
    for rec in srv._records.records:
        assert (rec.screened is not None) is screening
    assert all(torch.isfinite(v).all() for v in srv.params.values())


@pytest.mark.parametrize("spec,match", [
    ("lstm", "needs a text"),
    ("llama3.2-3b", "token-sequence architecture"),
    ("falcon-mamba-7b", "token-sequence architecture")])
def test_unported_models_raise(spec, match):
    """A token model on a dataset without tokens raises the reference's
    ValueError: "lstm" and the architecture ids alike."""
    with pytest.raises(ValueError, match=match):
        resolve_local_step(spec, tfemnist(**DS_KW))
    with pytest.raises(ValueError, match=match):
        jresolve(spec, jfemnist(**DS_KW))


@pytest.mark.parametrize("name,kw,lr,sampling,extra", [
    ("synthetic", dict(n_clients=20, total=1500, max_size=150), 0.01, "iid",
     {}),
    ("mnist", dict(n_clients=40, total=2400, dim=32, max_size=100), 0.03,
     "shuffle", {}),
    ("synthetic", dict(n_clients=20, total=1500, max_size=150), 0.01, "iid",
     dict(model="mlp", upload_compress="topk_q8"))])
def test_uninjected_final_accuracy_within_band(name, kw, lr, sampling,
                                               extra):
    """Without injection the port draws its own init and minibatches, so
    runs differ draw by draw; after 10 rounds the final test accuracy must
    still sit within 0.03 of the reference's."""
    cfg = dict(rounds=10, n_selected=5, lr=lr, sampling=sampling, **extra)
    ref_acc = JServer(jfed.DATASETS[name](**kw), cfg=JConfig(**cfg)).run()
    port_acc = TServer(tfed.DATASETS[name](**kw),
                       cfg=TConfig(device="cpu", **cfg)).run()
    assert abs(port_acc["acc"][-1] - ref_acc["acc"][-1]) <= 0.03
