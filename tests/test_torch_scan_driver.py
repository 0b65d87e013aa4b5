"""The port's device drivers (ROADMAP A12 (i)): ``driver="scan"`` and the
host driver with ``rng_impl="device"``, on the CPU.

Mirrors the reference's ``tests/test_scan_driver.py`` (all but its x64
legs) at the port's stricter bound: the scan driver is BITWISE the host
driver with device rng (cohorts, budgets, params, L/H/theta, values,
residual, quarantine counters, records but ``wall_time_s``; the scan
evaluates at block ends only, so its in-block records carry the previous
block's accuracy).  Then the float32 twins against the reference's twins,
and the port's scan driver against the reference's scan driver with the
reference's draws injected (``device_draws=`` with the workloads ``E``
themselves, since XLA's CPU build contracts the reference's jitted
``mu + sigma * z`` into an FMA; ``data_draws=``; ``fault_draws=``):
cohorts, budgets, L and H bitwise, params, losses and values within 2e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prediction as jpred
from repro.core import selection as jsel
from repro.core.heterogeneity import HeterogeneitySim as JHet
from repro.core.heterogeneity import sample_workloads_device as jsample
from repro.core.server import FedSAEServer as JServer
from repro.core.server import ServerConfig as JConfig
from repro.data.federated import make_femnist_like as jfemnist
from repro.faults import FaultModel as JFaultModel
from repro.core.heterogeneity import pareto_slowdowns as jpareto
from repro.faults import corrupt_mask as jcorrupt_mask
from repro.faults import dropout_mask as jdropout_mask
from repro.faults.inject import round_fault_key as jround_fault_key
from repro_torch.core import prediction as tpred
from repro_torch.core import selection as tsel
from repro_torch.core.engine import budget_iters
from repro_torch.core.heterogeneity import HeterogeneitySim
from repro_torch.core.heterogeneity import sample_workloads_device
from repro_torch.core.server import FedSAEServer, ServerConfig
from repro_torch.data.federated import make_femnist_like
from repro_torch.faults import FaultModel
from torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-5
DS = dict(n_clients=24, total=1400, dim=16, max_size=60)
N, K = 24, 8


@pytest.fixture(scope="module")
def fed():
    return make_femnist_like(**DS)


def _cfg(driver, **over):
    kw = dict(algo="ira", n_selected=K, rounds=8, h_cap=4.0,
              fixed_epochs=4.0, sampling="iid", block_size=4, device="cpu")
    kw.update(over)
    return ServerConfig(driver=driver,
                        rng_impl="device" if driver == "host" else "", **kw)


def _server(ds, driver, het=None, **over):
    return FedSAEServer(ds, cfg=_cfg(driver, **over),
                        het=het or HeterogeneitySim(ds.n_clients, seed=0))


def _records(srv):
    out = []
    for r in srv._records.records:
        d = json.loads(r.to_json())
        d.pop("wall_time_s")
        out.append(d)
    return out


def assert_same_run(host, scan, block):
    """Bitwise: cohorts, budgets, params, L/H/theta, values, residual,
    quarantine counters and records but wall_time_s; the scan's in-block
    records carry the previous block end's accuracy and no test loss."""
    assert len(host.cohorts) == len(scan.cohorts)
    for a, b in zip(host.cohorts, scan.cohorts):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(host.budgets, scan.budgets):
        np.testing.assert_array_equal(a, b)
    for k in host.params:
        assert torch.equal(host.params[k], scan.params[k]), k
    for name in ("L", "H", "theta", "q_fail", "q_try", "q_susp"):
        np.testing.assert_array_equal(getattr(host, name),
                                      getattr(scan, name))
    np.testing.assert_array_equal(host.values.v, scan.values.v)
    if host.residual is not None:
        assert torch.equal(host.residual, scan.residual)
    hr, sr = _records(host), _records(scan)
    assert len(hr) == len(sr)
    prev = (None, None)
    for i, (a, b) in enumerate(zip(hr, sr)):
        end = (i + 1) % block == 0 or i == len(hr) - 1
        for d in (a, b):
            acc, tl = d.pop("acc"), d.pop("test_loss")
            d["_eval"] = (acc, tl)
        ha, sa = a.pop("_eval"), b.pop("_eval")
        assert a == b, i
        if end:
            assert sa == ha, i
            prev = (ha[0], None)
        else:
            assert sa == prev, i


# ---------------------------------------------------------------------------
# driver parity: scan == host with the device rng streams, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["ira", "fassa"])
def test_scan_matches_host_driver(fed, algo):
    host = _server(fed, "host", algo=algo)
    scan = _server(fed, "scan", algo=algo)
    host.run()
    scan.run()
    assert len(scan.cohorts) == 8
    assert_same_run(host, scan, 4)


def test_scan_matches_host_driver_shuffle_sampling(fed):
    host = _server(fed, "host", sampling="shuffle")
    scan = _server(fed, "scan", sampling="shuffle")
    host.run(rounds=4)
    scan.run(rounds=4)
    assert_same_run(host, scan, 4)


def test_scan_matches_host_driver_mlp_topk_q8(fed):
    kw = dict(model="mlp", upload_compress="topk_q8", topk_frac=0.2)
    host = _server(fed, "host", **kw)
    scan = _server(fed, "scan", **kw)
    host.run(rounds=6)
    scan.run(rounds=6)
    assert_same_run(host, scan, 4)
    assert scan.residual.abs().sum() > 0


def test_scan_matches_host_driver_faults_quarantine(fed):
    """nan uploads screened, quarantine at 0.3 (one try suffices): the
    suspensions leave fewer than K eligible clients, so -inf scores tie
    in the top k."""
    kw = dict(faults=FaultModel(seed=3, corrupt="nan", corrupt_prob=0.6,
                                dropout_prob=0.1),
              quarantine_threshold=0.3, quarantine_rounds=8,
              quarantine_min_tries=1)
    host = _server(fed, "host", **kw)
    scan = _server(fed, "scan", **kw)
    host.run()
    scan.run()
    assert_same_run(host, scan, 4)
    quarantined = [r.quarantined for r in scan._records.records]
    assert max(quarantined) > N - K
    assert sum(r.screened for r in scan._records.records) > 0


def test_scan_matches_host_driver_stress(fed):
    """Diurnal availability, Pareto stragglers, dropouts and sign-flipped
    uploads under the median: the workload shaping runs on the device
    with the round index a device tensor."""
    kw = dict(faults=FaultModel(seed=5, availability="diurnal",
                                day_rounds=4, straggler="pareto",
                                pareto_alpha=1.5, dropout_prob=0.1,
                                corrupt="sign_flip", corrupt_prob=0.2),
              aggregator="median")
    host = _server(fed, "host", **kw)
    scan = _server(fed, "scan", **kw)
    host.run()
    scan.run()
    assert_same_run(host, scan, 4)
    assert min(host.history["true_workload"]) < max(
        host.history["true_workload"])


def test_fused_generic_runs_one_walk(fed):
    a = _server(fed, "scan", sampling="shuffle", fused_generic=True)
    b = _server(fed, "scan", sampling="shuffle", fused_generic=False)
    a.run(rounds=4)
    b.run(rounds=4)
    assert_same_run(a, b, 4)


def test_scan_partial_final_block(fed):
    scan = _server(fed, "scan")
    scan.run(rounds=6)   # blocks of 4 and 2
    assert len(scan.history["dropout"]) == 6
    assert len(scan.cohorts) == 6
    assert np.isfinite(scan.history["acc"][-1])
    host = _server(fed, "host")
    host.run(rounds=6)
    assert_same_run(host, scan, 4)


def test_device_run_round_matches_run(fed):
    """``run_round`` on the host driver with device rng runs the device
    round and syncs the host-side state after it: round by round it is
    the ``run`` loop."""
    a = _server(fed, "host")
    rows = [a.run_round(t) for t in range(3)]
    b = _server(fed, "host")
    b.run(rounds=3)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    for name in ("L", "H", "theta"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(a.values.v, b.values.v)
    for row, rec in zip(rows, b._records.records):
        assert row["ids"] == rec.ids and row["dropout"] == rec.dropout
    np.testing.assert_array_equal(rows[-1]["n_iters"], b.budgets[-1])


def test_scan_host_sync_budget(fed):
    host = _server(fed, "host")
    scan = _server(fed, "scan")
    host.run()
    scan.run()
    assert host.host_syncs >= 8          # >= one per round
    assert scan.host_syncs == 2 * 2      # 2 blocks x (stats pull + eval)


def test_scan_respects_eval_every(fed):
    scan = _server(fed, "scan", eval_every=100)
    scan.run(rounds=12)   # blocks of 4: 0-3 (t=0 due), 4-7 (skip), 8-11
    assert scan.host_syncs == 3 + 2
    assert len(scan.history["acc"]) == 12
    assert scan.history["acc"][7] == scan.history["acc"][3]
    assert np.isnan(scan.history["test_loss"][7])
    assert np.isfinite(scan.history["test_loss"][11])


def test_scan_crash_heavy_round(fed):
    crash = dict(mu_range=(0.0, 1e-3), sigma_frac=(0.0, 1e-3))
    host = _server(fed, "host", het=HeterogeneitySim(N, seed=0, **crash))
    scan = _server(fed, "scan", het=HeterogeneitySim(N, seed=0, **crash))
    p0 = {k: v.clone() for k, v in scan.params.items()}
    v0 = scan.values.v.copy()
    host.run()
    scan.run()
    assert np.allclose(host.history["dropout"], 1.0)
    assert np.allclose(scan.history["dropout"], 1.0)
    for k in p0:
        assert torch.equal(p0[k], scan.params[k])
    np.testing.assert_array_equal(v0.astype(np.float32),
                                  scan.values.v.astype(np.float32))
    np.testing.assert_array_equal(v0.astype(np.float32),
                                  host.values.v.astype(np.float32))
    assert all(np.isnan(host.history["train_loss"]))
    assert all(np.isnan(scan.history["train_loss"]))


def test_scan_state_is_float32(fed):
    scan = _server(fed, "scan")

    def dtypes():
        st = scan.device_state()
        return {st[k].dtype for k in ("L", "H", "theta", "values")}

    assert dtypes() == {torch.float32}
    scan.run(rounds=4)
    assert dtypes() == {torch.float32}


def test_scan_kill_resume_at_block_boundary(fed, tmp_path):
    kw = dict(model="mlp", upload_compress="topk_q8", topk_frac=0.2,
              faults=FaultModel(seed=3, corrupt="nan", corrupt_prob=0.3),
              quarantine_threshold=0.3, quarantine_min_tries=1)
    full = _server(fed, "scan", **kw)
    full.run()
    first = _server(fed, "scan", **kw)
    first.run(rounds=4, checkpoint_dir=str(tmp_path))
    resumed = _server(fed, "scan", **kw)
    resumed.run(checkpoint_dir=str(tmp_path), resume=True)
    assert_same_run(full, resumed, 4)
    assert torch.equal(full.sel_gen.get_state(), resumed.sel_gen.get_state())


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------


def test_unknown_driver_rejected(fed):
    with pytest.raises(ValueError, match="unknown driver"):
        FedSAEServer(fed, cfg=ServerConfig(driver="async", device="cpu"))


def test_scan_driver_requires_device_rng(fed):
    with pytest.raises(ValueError, match="device rng"):
        FedSAEServer(fed, cfg=ServerConfig(driver="scan", rng_impl="numpy",
                                           device="cpu"))


def test_quarantine_requires_screen_and_device_rng(fed):
    with pytest.raises(ValueError, match="upload screen"):
        FedSAEServer(fed, cfg=ServerConfig(quarantine_threshold=0.3,
                                           rng_impl="device", device="cpu"))
    with pytest.raises(ValueError, match="device rng streams"):
        FedSAEServer(fed, cfg=ServerConfig(quarantine_threshold=0.3,
                                           upload_screen="on",
                                           device="cpu"))


# ---------------------------------------------------------------------------
# device selection, value update, budgets
# ---------------------------------------------------------------------------


def _gumbel(seed, n):
    return tsel.gumbel_noise(torch.rand(n, generator=torch.Generator()
                                        .manual_seed(seed)))


def test_select_cohort_device_distinct_and_in_range():
    for strategy in ("random", "active", "loss_proportional"):
        ids = tsel.select_cohort_device(_gumbel(0, 50), torch.ones(50), 10,
                                        strategy, 0.01).numpy()
        assert len(set(ids.tolist())) == 10
        assert (ids >= 0).all() and (ids < 50).all()
    with pytest.raises(ValueError, match="unknown selection"):
        tsel.select_cohort_device(_gumbel(0, 50), torch.ones(50), 10,
                                  "round_robin", 0.01)


def test_select_cohort_device_active_prefers_high_values():
    v = torch.zeros(100)
    v[:10] = 500.0
    counts = np.zeros(100)
    for r in range(200):
        counts[tsel.select_cohort_device(_gumbel(r, 100), v, 10, "active",
                                         0.05).numpy()] += 1
    assert counts[:10].mean() > 5 * counts[10:].mean()


def test_select_cohort_device_al_flag_overrides_strategy():
    v = torch.from_numpy(np.random.default_rng(0).uniform(0, 100, 40)
                         .astype(np.float32))
    g = _gumbel(7, 40)
    active = tsel.select_cohort_device(g, v, 8, "active", 0.05)
    for use_al in (True, torch.tensor(True)):
        forced = tsel.select_cohort_device(g, v, 8, "random", 0.05,
                                           use_al=use_al)
        assert torch.equal(active, forced)
    off = tsel.select_cohort_device(g, v, 8, "random", 0.05,
                                    use_al=torch.tensor(False))
    assert torch.equal(off, tsel.select_cohort_device(g, v, 8, "random",
                                                      0.05))


def test_value_update_device_matches_tracker_and_skips_non_uploaders():
    sizes = np.array([4.0, 9.0, 16.0, 25.0, 36.0])
    tracker = tsel.ValueTracker(5, sizes)
    v0 = torch.as_tensor(tracker.v, dtype=torch.float32)
    out = tsel.value_update_device(v0, torch.as_tensor(sizes),
                                   torch.tensor([1, 3]),
                                   torch.tensor([10.0, 20.0]),
                                   torch.tensor([True, False])).numpy()
    tracker.update([1], [10.0])
    np.testing.assert_allclose(out, tracker.v, rtol=1e-6)
    assert out[3] == np.float32(tracker.v[3])


def test_device_hist_matches_histogram_counts():
    """The device histogram bins as ``obs.schema.histogram_counts`` (and
    the reference's ``_device_hist``), edges and out-of-range values
    included."""
    from repro.core.engine import _device_hist as jhist
    from repro_torch.core.engine import _device_hist
    from repro_torch.obs.schema import histogram_counts
    rng = np.random.default_rng(5)
    x = rng.uniform(-2.0, 30.0, 64).astype(np.float32)
    x[:4] = [0.0, 24.0, 12.0, 23.999998]
    w = (rng.random(64) < 0.7).astype(np.float32)
    for lo, hi, bins in ((0.0, 24.0, 16), (0.0, 8.0, 16)):
        got = _device_hist(torch.from_numpy(x), torch.from_numpy(w), lo, hi,
                           bins).numpy()
        np.testing.assert_array_equal(got, histogram_counts(x, w, lo, hi,
                                                            bins))
        np.testing.assert_array_equal(got, np.asarray(jhist(x, w, lo, hi,
                                                            bins)))


def test_budget_iters_matches_host_formula():
    rng = np.random.default_rng(1)
    e_eff = rng.uniform(0, 6, 32).astype(np.float32)
    n = rng.integers(1, 60, 32)
    got = budget_iters(torch.from_numpy(e_eff), torch.from_numpy(n), 10,
                       24).numpy()
    tau = np.ceil(n / 10).astype(np.float32)
    want = np.minimum(np.round(e_eff * tau), 24).astype(np.int32)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the float32 twins against the reference's
# ---------------------------------------------------------------------------


def _history(seed=3, n=64):
    rng = np.random.default_rng(seed)
    L = rng.uniform(0.25, 10.0, n).astype(np.float32)
    H = (L + rng.uniform(0.01, 8.0, n)).astype(np.float32)
    E = rng.uniform(0.0, 20.0, n).astype(np.float32)
    E[:4], E[4:8] = L[:4], H[4:8]                  # ties on the bounds
    theta = rng.uniform(0.0, 15.0, n).astype(np.float32)
    return L, H, E, theta


@pytest.mark.parametrize("algo", ["ira", "fassa", "fedavg", "fedprox",
                                  "oracle"])
def test_workload_update_device_matches_reference(algo):
    L, H, E, theta = _history()
    ids = np.random.default_rng(4).permutation(64)[:20]
    kw = dict(U=10.0, alpha=0.95, gamma1=3.0, gamma2=1.0, h_cap=24.0,
              fixed_epochs=15.0)
    want = jpred.workload_update_device(algo, L, H, theta,
                                        jnp.asarray(ids, jnp.int32),
                                        E[ids], **kw)
    got = tpred.workload_update_device(algo, L, H, theta,
                                       torch.from_numpy(ids), E[ids], **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_prediction_twins_match_reference():
    L, H, E, theta = _history()
    for h_cap in (0.0, 24.0):
        for w, g in zip(jpred.ira_predict_device(L, H, E, 7.0, h_cap),
                        tpred.ira_predict_device(L, H, E, 7.0, h_cap)):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        for w, g in zip(
                jpred.fassa_predict_device(L, H, E, theta, 2.5, 0.5, h_cap),
                tpred.fassa_predict_device(L, H, E, theta, 2.5, 0.5, h_cap)):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    np.testing.assert_array_equal(
        np.asarray(jpred.fassa_threshold_device(theta, E, 0.9)),
        tpred.fassa_threshold_device(theta, E, 0.9).numpy())
    np.testing.assert_array_equal(
        np.asarray(jpred.uploaded_epochs_device(L, H, E)),
        tpred.uploaded_epochs_device(L, H, E).numpy())


@pytest.mark.parametrize("strategy", ["random", "active",
                                      "loss_proportional"])
def test_selection_twins_match_reference(strategy):
    """The reference's Gumbel noise injected: the same ids, and with most
    clients ineligible (-inf ties) the ties resolve lowest index first on
    both."""
    v = np.random.default_rng(2).uniform(0, 60, N).astype(np.float32)
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        g = np.asarray(jax.random.gumbel(key, (N,), jnp.float32))
        elig = np.random.default_rng(seed).random(N) < 0.25
        for e in (None, elig):
            want = jsel.select_cohort_device(
                key, v, K, strategy, 0.05, use_al=seed % 2 == 1,
                elig=None if e is None else jnp.asarray(e))
            got = tsel.select_cohort_device(
                torch.from_numpy(g), torch.from_numpy(v), K, strategy, 0.05,
                use_al=seed % 2 == 1,
                elig=None if e is None else torch.from_numpy(e))
            np.testing.assert_array_equal(np.asarray(want), got.numpy())
    u = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    u[:3] = 0.0
    want = np.float32(-np.log(-np.log(np.maximum(
        u.numpy(), np.finfo(np.float32).tiny))))
    assert torch.isfinite(tsel.gumbel_noise(u)).all()
    np.testing.assert_allclose(tsel.gumbel_noise(u).numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_value_update_device_matches_reference():
    sizes = np.arange(1, N + 1).astype(np.float64)
    v = (np.sqrt(sizes) * 2.0).astype(np.float32)
    ids = np.array([3, 0, 17, 9])
    losses = np.array([0.5, 1.25, 2.0, 0.75], np.float32)
    up = np.array([True, False, True, True])
    want = jsel.value_update_device(v, sizes, jnp.asarray(ids, jnp.int32),
                                    losses, up)
    got = tsel.value_update_device(torch.from_numpy(v),
                                   torch.from_numpy(sizes),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(losses),
                                   torch.from_numpy(up))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_sample_workloads_device_within_one_ulp():
    """Bitwise the reference's eager twin (a product, then a sum); within
    one float32 ulp of its jitted one, which XLA's CPU build contracts
    into an FMA (one rounding fewer)."""
    het = JHet(500, seed=0)
    mu, sigma = het.device_params()
    tmu, tsigma = HeterogeneitySim(500, seed=0).device_params("cpu")
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        z = np.asarray(jax.random.normal(key, (500,), jnp.float32))
        got = sample_workloads_device(torch.from_numpy(z), tmu,
                                      tsigma).numpy()
        eager = np.asarray(jsample(key, mu, sigma))
        jitted = np.asarray(jax.jit(jsample)(key, mu, sigma))
        np.testing.assert_array_equal(got, eager)
        ulp = np.spacing(np.maximum.reduce([
            np.abs(got), np.abs(jitted), np.abs(np.asarray(mu)),
            np.abs(np.asarray(sigma) * z)]))
        assert (np.abs(got - jitted) <= ulp).all()
        assert (got != jitted).any()          # the FMA shows


# ---------------------------------------------------------------------------
# the port's scan driver against the reference's, the reference's draws
# injected
# ---------------------------------------------------------------------------


def _reference_streams(jsrv, T, sampling, fm=None):
    """The reference scan's per-round draws, from its own key discipline:
    sel_rng -> (k_sel, k_het) each round, E = max(mu + sigma * z, 0)
    under jit (the FMA its scan computes), the Gumbel noise; data_rng ->
    sub each round, then per-client randint/uniform; the fault masks."""
    mu, sigma = jsrv._mu_dev, jsrv._sigma_dev
    key, dkey = jax.random.PRNGKey(jsrv.cfg.selection_seed), \
        jax.random.PRNGKey(jsrv.cfg.seed)
    draws, subs = [], []
    jsample_jit = jax.jit(jsample)
    for _ in range(T):
        key, k_sel, k_het = jax.random.split(key, 3)
        draws.append({"E": np.asarray(jsample_jit(k_het, mu, sigma)),
                      "g": np.asarray(jax.random.gumbel(k_sel, (N,),
                                                        jnp.float32))})
        dkey, sub = jax.random.split(dkey)
        subs.append(sub)
    B, max_iters, max_n = jsrv.cfg.batch_size, jsrv.max_iters, jsrv.max_n

    def data_draws(t, ids, n):
        keys = jax.random.split(subs[t], len(ids))
        if sampling == "iid":
            return np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
                k, (max_iters, B), 0, jnp.maximum(nk, 1)))(
                keys, jnp.asarray(n, jnp.int32)))
        return np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (max_n,)))(keys))

    def fault_draws(t):
        key = jround_fault_key(fm.seed, t)
        return {"slowdown": (np.asarray(jpareto(
                    jax.random.fold_in(key, 0), fm.pareto_alpha, (N,)))
                    if fm.straggler == "pareto" else None),
                "dropout": (np.asarray(jdropout_mask(fm, t, N))
                            if fm.dropout_prob > 0 else None),
                "corrupt": (np.asarray(jcorrupt_mask(fm, t, N))
                            if fm.corrupts else None)}

    return (lambda t: draws[t]), data_draws, fault_draws


def _reference_budgets(monkeypatch):
    """Record each round's budgets from inside the reference's jitted
    segment (a debug callback on its ``budget_iters``)."""
    import repro.core.engine as jengine
    real, seen = jengine.budget_iters, []

    def spy(e_eff, n, batch_size, max_iters):
        out = real(e_eff, n, batch_size, max_iters)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), out,
                           ordered=True)
        return out

    monkeypatch.setattr(jengine, "budget_iters", spy)
    return seen


REF_CASES = {
    "ira-iid": dict(algo="ira"),
    "fassa-iid": dict(algo="fassa"),
    "ira-shuffle": dict(sampling="shuffle"),
    "mlp-topk_q8": dict(model="mlp", upload_compress="topk_q8",
                        topk_frac=0.2),
    "faults-quarantine": dict(faults="nan", upload_screen="on",
                              quarantine_threshold=0.3,
                              quarantine_rounds=4, quarantine_min_tries=1),
    "faults-stress": dict(faults="stress", aggregator="median"),
}

#: the fault models of the reference cases, as FaultModel arguments
REF_FAULTS = {
    "nan": dict(seed=3, corrupt="nan", corrupt_prob=0.4),
    "stress": dict(seed=5, availability="diurnal", day_rounds=4,
                   straggler="pareto", pareto_alpha=1.5, dropout_prob=0.1,
                   corrupt="sign_flip", corrupt_prob=0.2),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_scan_matches_reference_scan(monkeypatch, case):
    over = dict(REF_CASES[case])
    T = 8                     # two blocks of 4: one reference compile
    jfm = tfm = None
    faults = over.pop("faults", None)
    if faults:
        jfm = JFaultModel(**REF_FAULTS[faults])
        tfm = FaultModel(**REF_FAULTS[faults])
    base = dict(algo="ira", n_selected=K, rounds=T, h_cap=4.0,
                fixed_epochs=4.0, sampling="iid", block_size=4)
    base.update(over)
    budgets = _reference_budgets(monkeypatch)
    jsrv = JServer(jfemnist(**DS), cfg=JConfig(driver="scan", faults=jfm,
                                                **base))
    init = jax.tree.map(np.asarray, jsrv.params)
    jsrv.run()
    device_draws, data_draws, fault_draws = _reference_streams(
        jsrv, T, base["sampling"], jfm)
    tsrv = FedSAEServer(
        make_femnist_like(**DS),
        cfg=ServerConfig(driver="scan", device="cpu", faults=tfm, **base),
        init_params=init, device_draws=device_draws, data_draws=data_draws,
        fault_draws=fault_draws if jfm is not None else None)
    tsrv.run()
    for a, b in zip(jsrv.cohorts, tsrv.cohorts):
        np.testing.assert_array_equal(a, b)
    assert len(budgets) == T
    for a, b in zip(budgets, tsrv.budgets):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jsrv.L, tsrv.L)
    np.testing.assert_array_equal(jsrv.H, tsrv.H)
    # fassa's threshold a * theta + (1 - a) * E: an FMA in the reference's
    # jitted scan, two rounded products in the port (its eager twin's): an
    # ulp a round at most, carried on by the moving average
    np.testing.assert_allclose(jsrv.theta, tsrv.theta, rtol=1e-6)
    np.testing.assert_allclose(jsrv.values.v, tsrv.values.v, rtol=TOL)
    for k in init:
        np.testing.assert_allclose(np.asarray(jsrv.params[k]),
                                   tsrv.params[k].numpy(), atol=TOL)
    np.testing.assert_allclose(jsrv.history["train_loss"],
                               tsrv.history["train_loss"], atol=TOL)
    if faults == "nan":
        for name in ("q_fail", "q_try", "q_susp"):
            np.testing.assert_array_equal(getattr(jsrv, name),
                                          getattr(tsrv, name))
        for a, b in zip(jsrv._records.records, tsrv._records.records):
            assert (a.screened, a.quarantined) == (b.screened,
                                                   b.quarantined)
        assert max(r.quarantined for r in tsrv._records.records) > 0
