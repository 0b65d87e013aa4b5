"""The port's failure handling (``repro_torch.faults``, the fault path of
``core.engine``/``core.server``/``core.silo``) against the reference, on
the CPU.

- Units: ``FaultModel`` (the reference's copy: validation messages and
  ``phases`` bitwise); the port's own fault stream, a pure function of
  (seed, t); the diurnal duty cycle and the Pareto floor; the
  injection, the screen and the quarantine bookkeeping bitwise against
  the reference's on the same numpy stacks.
- The hazard and the defense: unscreened FedAvg is poisoned by a NaN row
  at weight 0; behind the screen every registry aggregator equals the
  crash twin's aggregate.
- Host-driver parity: the port's ``FedSAEServer`` against the reference's
  host driver with the reference's init, minibatch draws and fault draws
  injected (``init_params=``, ``data_draws=``, ``fault_draws=``), for
  every corrupt mode and for diurnal + Pareto + dropout, on MCLR iid and
  shuffle and the MLP with topk_q8: cohorts, budgets, L/H/theta and the
  screened counts bitwise; params and losses within 2e-5 (compressed
  rounds: losses only, since top-k ties may flip the kept sets).
- The crash-twin theorem on the port: nan/inf/explode runs are bitwise
  their ``corrupt="crash"`` twins (params, history, cohorts, residuals).
- Composition: an all-faulty round is a no-op, sign_flip passes the
  screen, faults off and a screen with no fault are the plain program,
  a faulted run reproduces itself; the silo screen against the
  reference's; the health report's "Faults & defenses" section from a
  port run's JSONL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregation import AGGREGATORS as JAGGREGATORS
from repro.core.aggregation import get_aggregator as jget_aggregator
from repro.core.heterogeneity import pareto_slowdowns as jpareto
from repro.core.server import FedSAEServer as JServer
from repro.core.server import ServerConfig as JConfig
from repro.data.federated import make_femnist_like as jfemnist
from repro.faults import FaultModel as JFaultModel
from repro.faults import availability_mask as javailability
from repro.faults import corrupt_mask as jcorrupt_mask
from repro.faults import dropout_mask as jdropout_mask
from repro.faults import eligibility as jeligibility
from repro.faults import inject_upload_faults as jinject
from repro.faults import quarantine_update as jquarantine_update
from repro.faults import screen_uploads as jscreen
from repro.faults.inject import round_fault_key
from repro_torch.core.aggregation import AGGREGATORS, get_aggregator
from repro_torch.core.server import FedSAEServer as TServer
from repro_torch.core.server import ServerConfig as TConfig
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.faults import (AVAILABILITY_MODES, CORRUPT_MODES,
                                INJECTED_CORRUPT, SCREENED_CORRUPT,
                                STRAGGLER_MODES, FaultModel,
                                apply_availability_stragglers,
                                availability_mask, corrupt_mask,
                                dropout_mask, eligibility,
                                inject_upload_faults, quarantine_update,
                                round_fault_draws, screen_uploads,
                                straggler_slowdowns)
from repro_torch.launch import fl_train
from torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-5
DS_KW = dict(n_clients=20, total=600, dim=16, max_size=24)
CFG_KW = dict(n_selected=6, lr=0.05, batch_size=4, rounds=3, h_cap=6.0,
              fixed_epochs=4.0, selection="random")


# ---------------------------------------------------------------------------
# FaultModel and the port's fault stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(availability="sometimes"), dict(straggler="gamma"),
    dict(corrupt="gamma_rays"), dict(availability="diurnal", day_rounds=0),
    dict(duty_cycle=0.0), dict(duty_cycle=1.5), dict(dropout_prob=1.5),
    dict(corrupt_prob=-0.1), dict(straggler="pareto", pareto_alpha=0.0)])
def test_fault_model_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        JFaultModel(**kw)
    with pytest.raises(ValueError, match=str(want.value).replace(
            "(", r"\(").replace(")", r"\)").replace("[", r"\[").replace(
            "]", r"\]")):
        FaultModel(**kw)


def test_fault_model_properties_and_phases_match_reference():
    from repro.faults import model as jmodel
    assert (AVAILABILITY_MODES, STRAGGLER_MODES, CORRUPT_MODES,
            SCREENED_CORRUPT, INJECTED_CORRUPT) == (
        jmodel.AVAILABILITY_MODES, jmodel.STRAGGLER_MODES,
        jmodel.CORRUPT_MODES, jmodel.SCREENED_CORRUPT,
        jmodel.INJECTED_CORRUPT)
    for corrupt in CORRUPT_MODES:
        for prob in (0.0, 0.3):
            kw = dict(seed=5, corrupt=corrupt, corrupt_prob=prob,
                      availability="diurnal", day_rounds=7, duty_cycle=0.3)
            a, b = FaultModel(**kw), JFaultModel(**kw)
            assert (a.corrupts, a.demotes, a.injects, a.duty_len) == (
                b.corrupts, b.demotes, b.injects, b.duty_len)
            np.testing.assert_array_equal(a.phases(50), b.phases(50))
            assert a.phases(50).dtype == np.int32
    assert FaultModel().phases(50) is None


def test_fault_stream_is_a_pure_function_of_seed_and_round():
    fm = FaultModel(seed=7, corrupt="nan", corrupt_prob=0.3,
                    dropout_prob=0.2, availability="diurnal",
                    straggler="pareto")
    for t in (0, 5, 17):
        a, b = round_fault_draws(fm, t, 200), round_fault_draws(fm, t, 200)
        for k in ("slowdown", "dropout", "corrupt"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["slowdown"].dtype == np.float32
        assert a["corrupt"].dtype == bool and a["dropout"].dtype == bool
    # different rounds, axes and seeds draw different schedules
    assert not np.array_equal(corrupt_mask(fm, 0, 200),
                              corrupt_mask(fm, 1, 200))
    assert not np.array_equal(corrupt_mask(fm, 3, 200),
                              dropout_mask(fm, 3, 200))
    other = FaultModel(seed=8, corrupt="nan", corrupt_prob=0.3)
    assert not np.array_equal(corrupt_mask(fm, 0, 200),
                              corrupt_mask(other, 0, 200))
    # drawing round 9 first changes nothing: no state between rounds
    late = corrupt_mask(fm, 9, 200)
    fresh = FaultModel(seed=7, corrupt="nan", corrupt_prob=0.3)
    np.testing.assert_array_equal(corrupt_mask(fresh, 9, 200), late)
    # disabled axes draw nothing
    off = round_fault_draws(FaultModel(), 0, 50)
    assert off == {"slowdown": None, "dropout": None, "corrupt": None}
    # the rates hold over many clients
    assert abs(corrupt_mask(fm, 0, 20000).mean() - 0.3) < 0.02
    assert abs(dropout_mask(fm, 0, 20000).mean() - 0.2) < 0.02


def test_diurnal_duty_cycle_and_pareto_floor():
    fm = FaultModel(seed=0, availability="diurnal", day_rounds=10,
                    duty_cycle=0.3, straggler="pareto", pareto_alpha=1.5)
    jfm = JFaultModel(seed=0, availability="diurnal", day_rounds=10,
                      duty_cycle=0.3, straggler="pareto", pareto_alpha=1.5)
    phases = fm.phases(400)
    on = np.stack([availability_mask(fm, phases, t) for t in range(10)])
    # every client is on duty for exactly duty_len rounds per day
    np.testing.assert_array_equal(on.sum(axis=0), fm.duty_len)
    for t in range(10):
        np.testing.assert_array_equal(
            on[t], np.asarray(javailability(jfm, jnp.asarray(phases), t)))
    slow = straggler_slowdowns(fm, 0, 400)
    assert (slow >= 1.0).all() and slow.max() > 2.0
    E = np.full(400, 8.0)
    shaped = apply_availability_stragglers(fm, phases, 0, E)
    off = ~availability_mask(fm, phases, 0)
    assert (shaped[off] == 0.0).all()
    np.testing.assert_array_equal(shaped[~off],
                                  8.0 / slow[~off].astype(np.float64))
    assert (shaped[~off] <= 8.0).all() and (shaped[~off] > 0.0).all()


def test_pareto_formula_matches_reference():
    """The reference's ``(1 - u) ** (-1/alpha)`` on the same float32
    uniforms, within an ulp (pow is not bitwise across frameworks)."""
    from repro_torch.core.heterogeneity import pareto_slowdowns
    u = np.random.default_rng(3).random(1000, dtype=np.float32)
    for alpha in (0.5, 1.5, 3.0):
        got = pareto_slowdowns(np.random.default_rng(3), alpha, (1000,))
        want = np.asarray((1.0 - jnp.asarray(u)) ** jnp.float32(-1 / alpha))
        np.testing.assert_allclose(got, want, rtol=2e-7)
        assert got.min() >= 1.0


def _stack(seed=0, K=6, dim=16):
    rng = np.random.default_rng(seed)
    g = {"w": np.full((dim, 3), 0.1, np.float32),
         "b": np.zeros((3,), np.float32)}
    pk = {"w": (0.1 + 0.01 * rng.normal(size=(K, dim, 3))).astype(
        np.float32), "b": (0.01 * rng.normal(size=(K, 3))).astype(np.float32)}
    return g, pk


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("mode", INJECTED_CORRUPT)
def test_inject_upload_faults_matches_reference(mode):
    g, pk = _stack()
    mask = np.array([True, False, True, False, False, True])
    got = inject_upload_faults(_t(pk), _t(g), torch.from_numpy(mask), mode,
                               100.0)
    want = jinject(_j(pk), _j(g), jnp.asarray(mask), mode, 100.0)
    for k in pk:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy()[~mask], pk[k][~mask])
    with pytest.raises(ValueError):
        inject_upload_faults(_t(pk), _t(g), torch.from_numpy(mask), "crash")


@pytest.mark.parametrize("case", ["clean", "nan", "inf", "explode",
                                  "zero_weight", "bound"])
def test_screen_uploads_matches_reference(case):
    g, pk = _stack(1)
    w = np.ones(6, np.float32)
    bound = 1e4
    if case in ("nan", "inf", "explode"):
        val = {"nan": np.nan, "inf": np.inf, "explode": 1e6}[case]
        pk["w"][2, 3, 1] = val
        pk["b"][4] = val
    elif case == "zero_weight":            # a crashed row is no fault
        pk["w"][2] = np.nan
        w[2] = 0.0
    elif case == "bound":                  # a finite row over the bound
        pk["w"][1] += 0.5
        bound = 1.0
    got_k, got_w, got_bad = screen_uploads(_t(g), _t(pk), torch.from_numpy(
        w), bound)
    want_k, want_w, want_bad = jscreen(_j(g), _j(pk), jnp.asarray(w), bound)
    assert got_bad.device.type == "cpu" and got_bad.dtype == torch.bool
    np.testing.assert_array_equal(got_bad.numpy(), np.asarray(want_bad))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    for k in pk:
        np.testing.assert_array_equal(got_k[k].numpy(),
                                      np.asarray(want_k[k]))
    want_n = {"clean": 0, "nan": 2, "inf": 2, "explode": 2,
              "zero_weight": 0, "bound": 1}[case]
    assert int(got_bad.sum()) == want_n


def test_screen_sanitizes_in_place_row_by_row(monkeypatch):
    """With a chunk smaller than a row the screen reads one row at a time
    and writes the global params into the rejected rows of the caller's
    stack; the verdicts are the whole-leaf screen's."""
    from repro_torch.faults import screen as tscreen
    g, pk = _stack(2)
    pk["w"][3] = np.inf
    want = screen_uploads(_t(g), _t(pk), torch.ones(6), 1e4)
    monkeypatch.setattr(tscreen, "SCREEN_CHUNK_BYTES", 8)
    stack = _t(pk)
    out, w, bad = screen_uploads(_t(g), stack, torch.ones(6), 1e4)
    assert out["w"] is stack["w"]
    np.testing.assert_array_equal(bad.numpy(), want[2].numpy())
    np.testing.assert_array_equal(stack["w"][3].numpy(), g["w"])
    for k in pk:
        assert torch.equal(out[k], want[0][k])


def test_quarantine_update_and_eligibility_match_reference():
    rng = np.random.default_rng(4)
    N, K = 12, 5
    t_state = [torch.zeros(N, dtype=torch.int32) for _ in range(3)]
    j_state = [jnp.zeros((N,), jnp.int32) for _ in range(3)]
    n_trips = 0
    for t in range(12):
        ids = rng.choice(N, K, replace=False).astype(np.int32)
        att = rng.random(K) < 0.8
        bad = att & (rng.random(K) < 0.6)
        *t_state, tn = quarantine_update(
            *t_state, torch.from_numpy(ids), torch.from_numpy(att),
            torch.from_numpy(bad), t, 0.5, 3, 2)
        *j_state, jn = jquarantine_update(
            *j_state, jnp.asarray(ids), jnp.asarray(att), jnp.asarray(bad),
            t, 0.5, 3, 2)
        for a, b in zip(t_state, j_state):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(tn) == int(jn)
        n_trips += int(tn)
        np.testing.assert_array_equal(
            eligibility(t_state[2], t + 1).numpy(),
            np.asarray(jeligibility(j_state[2], t + 1)))
    assert n_trips > 0


# ---------------------------------------------------------------------------
# the hazard and the defense
# ---------------------------------------------------------------------------


def test_unscreened_fedavg_is_poisoned_by_a_nan_row_at_weight_zero():
    g, pk = _stack(3)
    pk["w"][0] = np.nan
    w = torch.ones(6)
    w[0] = 0.0
    out = get_aggregator("fedavg")(_t(pk), _t(g), w)
    assert not torch.isfinite(out["w"]).all()


@pytest.mark.parametrize("name", sorted(AGGREGATORS))
def test_every_aggregator_is_clean_behind_the_screen(name):
    assert set(AGGREGATORS) == set(JAGGREGATORS)
    g, pk = _stack(4, K=8)
    poisoned = {k: v.copy() for k, v in pk.items()}
    poisoned["w"][3] = np.nan
    clean, w2, bad = screen_uploads(_t(g), _t(poisoned), torch.ones(8), 1e4)
    kwargs = {"n_byzantine": 1} if name in ("krum", "bulyan") else {}
    out = get_aggregator(name, **kwargs)(clean, _t(g), w2)
    assert all(torch.isfinite(v).all() for v in out.values())
    crashed = {k: v.copy() for k, v in pk.items()}
    for k in crashed:
        crashed[k][3] = g[k]
    w = torch.ones(8)
    w[3] = 0.0
    want = get_aggregator(name, **kwargs)(_t(crashed), _t(g), w)
    jwant = jget_aggregator(name, **kwargs)(_j(crashed), _j(g),
                                            jnp.asarray(w.numpy()))
    for k in want:
        assert torch.equal(out[k], want[k])
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jwant[k]),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# host-driver parity with the reference's host driver
# ---------------------------------------------------------------------------


def _reference_draws(seed, T, max_iters, B, max_n, sampling):
    """The reference host driver's per-round minibatch draws."""
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


def _reference_fault_draws(jfm, n_clients):
    """The reference's threefry fault schedule, in the shape of
    ``round_fault_draws``."""
    def draws(t):
        slow = None
        if jfm.straggler == "pareto":
            slow = np.asarray(jpareto(
                jax.random.fold_in(round_fault_key(jfm.seed, t), 0),
                jfm.pareto_alpha, (n_clients,)))
        drop = jdropout_mask(jfm, t, n_clients)
        bad = jcorrupt_mask(jfm, t, n_clients)
        return {"slowdown": slow,
                "dropout": None if drop is None else np.asarray(drop),
                "corrupt": None if bad is None else np.asarray(bad)}
    return draws


FAULT_CASES = {
    "crash": dict(corrupt="crash", corrupt_prob=0.4),
    "nan": dict(corrupt="nan", corrupt_prob=0.4),
    "inf": dict(corrupt="inf", corrupt_prob=0.4),
    "sign_flip": dict(corrupt="sign_flip", corrupt_prob=0.4),
    "explode": dict(corrupt="explode", corrupt_prob=0.4),
    "diurnal_pareto_dropout": dict(availability="diurnal", day_rounds=4,
                                   duty_cycle=0.75, straggler="pareto",
                                   pareto_alpha=1.5, dropout_prob=0.2),
}
PATHS = {"mclr-iid": dict(sampling="iid"),
         "mclr-shuffle": dict(sampling="shuffle"),
         "mlp-topk_q8": dict(sampling="iid", model="mlp",
                             upload_compress="topk_q8", topk_frac=0.1)}


@pytest.mark.parametrize("fault", sorted(FAULT_CASES))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_faulted_host_rounds_match_reference(path, fault):
    kw = dict(CFG_KW, **PATHS[path])
    fkw = dict(seed=3, **FAULT_CASES[fault])
    jfm = JFaultModel(**fkw)
    jsrv = JServer(jfemnist(**DS_KW), cfg=JConfig(algo="ira", faults=jfm,
                                                  **kw))
    init = jax.tree.map(np.asarray, jsrv.params)
    jhist = jsrv.run()
    tds = tfemnist(**DS_KW)
    tsrv = TServer(tds, cfg=TConfig(algo="ira", faults=FaultModel(**fkw),
                                    device="cpu", **kw),
                   init_params=init,
                   data_draws=_reference_draws(
                       0, kw["rounds"], jsrv.max_iters, kw["batch_size"],
                       int(tds.sizes.max()), kw["sampling"]),
                   fault_draws=_reference_fault_draws(jfm, tds.n_clients))
    thist = tsrv.run()
    for a, b in zip(tsrv.cohorts, jsrv.cohorts):
        np.testing.assert_array_equal(a, b)
    for name in ("L", "H", "theta"):
        np.testing.assert_array_equal(getattr(tsrv, name),
                                      getattr(jsrv, name))
    for k in ("dropout", "dropped", "assigned", "uploaded",
              "true_workload"):
        np.testing.assert_array_equal(thist[k], jhist[k])
    trecs, jrecs = tsrv._records.records, jsrv._records.records
    assert [r.screened for r in trecs] == [r.screened for r in jrecs]
    if fault in ("nan", "inf", "explode"):
        assert sum(r.screened for r in trecs) > 0
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tsrv.values.v, jsrv.values.v, rtol=TOL,
                               atol=TOL)
    if path == "mlp-topk_q8":
        # compressed rounds: kept sets may flip at ties (the set-based
        # contract); the residual rows of never-uploading clients are 0 in
        # both, and the rest finite
        zero_t = ~tsrv.residual.numpy().any(axis=1)
        zero_j = ~np.asarray(jsrv.residual).any(axis=1)
        np.testing.assert_array_equal(zero_t, zero_j)
        assert np.isfinite(tsrv.residual.numpy()).all()
        return
    for k in init:
        np.testing.assert_allclose(tsrv.params[k].numpy(),
                                   np.asarray(jsrv.params[k]),
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the crash twin, bitwise, on the port
# ---------------------------------------------------------------------------

_RUNS = {}


def _run(path, corrupt=None, rounds=6, prob=0.4, **over):
    """Memoized small port run on the CPU with the port's fault stream."""
    key = (path, corrupt, rounds, prob, tuple(sorted(over.items())))
    if key not in _RUNS:
        fm = None if corrupt is None else FaultModel(
            seed=3, corrupt=corrupt, corrupt_prob=prob)
        cfg = TConfig(algo="ira", device="cpu", faults=fm,
                      **dict(CFG_KW, rounds=rounds, **PATHS[path], **over))
        srv = TServer(tfemnist(**DS_KW), cfg=cfg)
        srv.run()
        _RUNS[key] = srv
    return _RUNS[key]


def _assert_bitwise(a, b):
    assert len(a.cohorts) == len(b.cohorts)
    for c1, c2 in zip(a.cohorts, b.cohorts):
        np.testing.assert_array_equal(c1, c2)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for name in ("L", "H", "theta"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(a.values.v, b.values.v)
    if a.residual is not None:
        assert torch.equal(a.residual, b.residual)


def _finite(srv):
    return all(torch.isfinite(v).all() for v in srv.params.values())


@pytest.mark.parametrize("mode", ["nan", "inf", "explode"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_crash_twin_bitwise(path, mode):
    twin = _run(path, "crash")
    faulted = _run(path, mode)
    assert _finite(faulted)
    assert sum(r.screened for r in faulted._records.records) > 0
    _assert_bitwise(twin, faulted)
    # the history saw crashes: the screened rows never reached it
    np.testing.assert_array_equal(twin.history["dropped"],
                                  faulted.history["dropped"])


def test_all_faulty_round_is_a_noop():
    """corrupt_prob=1: every upload is screened out, so every round is
    the no-participant no-op: the params stay the init, bitwise."""
    ds = tfemnist(**DS_KW)
    out = {}
    for corrupt in ("crash", "nan"):
        srv = TServer(ds, cfg=TConfig(
            algo="ira", device="cpu", sampling="iid",
            faults=FaultModel(seed=0, corrupt=corrupt, corrupt_prob=1.0),
            **CFG_KW))
        init = {k: v.clone() for k, v in srv.params.items()}
        srv.run()
        for k in init:
            assert torch.equal(srv.params[k], init[k])
        out[corrupt] = srv
    _assert_bitwise(out["crash"], out["nan"])
    assert all(r.screened > 0 for r in out["nan"]._records.records)


def test_sign_flip_passes_the_screen_and_stays_finite():
    flipped = _run("mclr-iid", "sign_flip", upload_screen="on")
    assert _finite(flipped)
    assert sum(r.screened for r in flipped._records.records) == 0
    honest = _run("mclr-iid", None, upload_screen="on")
    assert any(not torch.equal(flipped.params[k], honest.params[k])
               for k in honest.params), "sign_flip never reached FedAvg"
    assert _finite(_run("mclr-iid", "sign_flip", aggregator="median"))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_faults_off_and_idle_screen_are_the_plain_program(path):
    plain = _run(path, None)
    _assert_bitwise(plain, _run(path, None, screen_norm_bound=123.0))
    screened = _run(path, None, upload_screen="on")
    _assert_bitwise(plain, screened)
    assert all(r.screened == 0 for r in screened._records.records)
    assert all(r.screened is None for r in plain._records.records)


def test_faulted_run_reproduces_itself():
    fm = dict(seed=11, corrupt="nan", corrupt_prob=0.3, dropout_prob=0.2,
              availability="diurnal", day_rounds=4, straggler="pareto")
    runs = []
    for _ in range(2):
        srv = TServer(tfemnist(**DS_KW), cfg=TConfig(
            algo="ira", device="cpu", sampling="iid",
            faults=FaultModel(**fm), **dict(CFG_KW, rounds=6)))
        srv.run()
        runs.append(srv)
    _assert_bitwise(*runs)
    assert ([r.screened for r in runs[0]._records.records]
            == [r.screened for r in runs[1]._records.records])
    assert _finite(runs[0])


def test_quarantine_needs_the_screen_and_device_rng():
    ds = tfemnist(**DS_KW)
    with pytest.raises(ValueError, match="requires the upload screen"):
        TServer(ds, cfg=TConfig(device="cpu", quarantine_threshold=0.5,
                                upload_screen="off"))
    with pytest.raises(ValueError, match="needs the device rng streams"):
        TServer(ds, cfg=TConfig(
            device="cpu", quarantine_threshold=0.5,
            faults=FaultModel(corrupt="nan", corrupt_prob=0.2)))
    with pytest.raises(ValueError, match="unknown upload_screen"):
        TServer(ds, cfg=TConfig(device="cpu", upload_screen="maybe"))


# ---------------------------------------------------------------------------
# the silo screen and the report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bound", [1e4, 1e-12])
def test_silo_screen_matches_reference(bound):
    """``SiloFedSAE(screen_norm=)`` on the float32 smoke Llama against the
    reference's: the same screened count (none at 1e4, every uploading
    silo at 1e-12) and the global params within 2e-5."""
    from repro.configs import get_config as jget_config
    from repro.core.silo import SiloFedSAE as JSilo
    from repro.models.api import build_model as jbuild_model
    from repro_torch.configs import get_config
    from repro_torch.core.silo import SiloFedSAE
    from repro_torch.models.api import build_model
    from repro_torch.obs import RingBufferSink
    from repro.obs import RingBufferSink as JRing

    K, max_steps = 2, 2
    jcfg = jget_config("llama3.2-3b", smoke=True).replace(dtype="float32")
    tcfg = get_config("llama3.2-3b", smoke=True).replace(dtype="float32")
    jring, tring = JRing(), RingBufferSink()
    jfed = JSilo(jbuild_model(jcfg), K, lr=5e-3, max_steps=max_steps,
                 screen_norm=bound, sink=jring)
    tfed = SiloFedSAE(build_model(tcfg), K, lr=5e-3, max_steps=max_steps,
                      screen_norm=bound, sink=tring,
                      init_params=jax.tree.map(np.asarray, jfed.params),
                      device="cpu")
    ri = np.random.default_rng(0)
    sizes = np.asarray(ri.integers(100, 1000, K))
    toks = fl_train.silo_tokens(ri, tcfg, K, max_steps, S=16)
    jfed.run_round({"tokens": jnp.asarray(toks),
                    "labels": jnp.asarray(toks)}, sizes)
    tfed.run_round({"tokens": toks, "labels": toks}, sizes)
    assert tring.last.screened == jring.last.screened
    want = 0.0 if bound > 1 else float((tfed.last_n_steps > 0).sum())
    assert tring.last.screened == want
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jfed.params)[0]}
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(
               jax.tree.map(lambda t: t.numpy(), tfed.params))[0]}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_report_faults_section_from_a_port_run(tmp_path, capsys):
    from repro.obs import render_report as jrender
    from repro_torch.launch import fl_report
    from repro_torch.obs import read_jsonl, render_report
    path = str(tmp_path / "run.jsonl")
    fl_train.main(["--device", "cpu", "--rounds", "3", "--quiet",
                   "--faults", "nan_upload", "--fault-prob", "0.5",
                   "--metrics-out", path])
    out = capsys.readouterr().out
    meta, records = read_jsonl(path)
    n = sum(r.screened for r in records)
    assert n > 0 and f"screened={n:.0f} uploads" in out
    rep = render_report(meta, records)
    assert "Faults & defenses" in rep
    assert f"rejected by the finite/norm screen: **{n:.0f}**" in rep
    assert rep == jrender(meta, records)
    fl_report.main([path])
    assert "Faults & defenses" in capsys.readouterr().out
