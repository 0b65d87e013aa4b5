"""Shared parts of the port's sharding and capacity tests: the reference's
draws for injection, a spy on its budgets, and the comparisons.  Imports
JAX and the reference; the spawned ranks' module
(``torch_shard_worker.py``) does not."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core.heterogeneity import sample_workloads_device as jsample
from repro.faults.inject import corrupt_mask as jcorrupt_mask
from repro.faults.inject import dropout_mask as jdropout_mask

TOL = 2e-5
#: the reference's sharding tests' federation and config
DS24 = dict(n_clients=24, total=1400, dim=16, max_size=60)
DS25 = dict(n_clients=25, total=1450, dim=16, max_size=60)   # one ghost
BASE = dict(algo="ira", n_selected=8, rounds=6, h_cap=4.0, fixed_epochs=4.0,
            block_size=3)


def reference_draws(jsrv, T, jitted_E):
    """Round by round, the draws the finished reference server ``jsrv``
    made, for ``FedSAEServer(device_draws=, data_draws=)``: its key
    discipline (sel_rng -> (k_sel, k_het), data_rng -> sub each round),
    the workloads ``E`` (jitted, the FMA of the reference's scan, or
    eager, its host driver's), the Gumbel noise, and the per-slot
    minibatch draws of its cohorts (randint iid, uniform shuffle)."""
    cfg = jsrv.cfg
    N = jsrv.ds.n_clients
    mu, sigma = jsrv._mu_dev, jsrv._sigma_dev
    sample = jax.jit(jsample) if jitted_E else jsample
    key = jax.random.PRNGKey(cfg.selection_seed)
    dkey = jax.random.PRNGKey(cfg.seed)
    B, max_iters, max_n = cfg.batch_size, jsrv.max_iters, jsrv.max_n
    device, data = [], []
    for t in range(T):
        key, k_sel, k_het = jax.random.split(key, 3)
        device.append({"E": np.asarray(sample(k_het, mu, sigma)),
                       "g": np.asarray(jax.random.gumbel(k_sel, (N,),
                                                         jnp.float32))})
        dkey, sub = jax.random.split(dkey)
        ids = np.asarray(jsrv.cohorts[t])
        n = np.minimum(jsrv.sizes[ids], max_n)
        keys = jax.random.split(sub, len(ids))
        if cfg.sampling == "iid":
            data.append(np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
                k, (max_iters, B), 0, jnp.maximum(nk, 1)))(
                keys, jnp.asarray(n, jnp.int32))))
        else:
            data.append(np.asarray(jax.vmap(
                lambda k: jax.random.uniform(k, (max_n,)))(keys)))
    return device, data


def reference_fault_draws(fm, T, N):
    """The reference's threefry fault masks, round by round, for
    ``FedSAEServer(fault_draws=)`` (no straggler or availability axes)."""
    return [{"slowdown": None,
             "dropout": (np.asarray(jdropout_mask(fm, t, N))
                         if fm.dropout_prob > 0 else None),
             "corrupt": (np.asarray(jcorrupt_mask(fm, t, N))
                         if fm.corrupts else None)} for t in range(T)]


def spy_budgets(monkeypatch):
    """Record the budgets the reference computes, from its host driver's
    eager call and from inside its jitted segment (a debug callback)."""
    import repro.core.engine as jengine
    import repro.core.server as jserver
    real, seen = jengine.budget_iters, []

    def spy(e_eff, n, batch_size, max_iters):
        out = real(e_eff, n, batch_size, max_iters)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), out,
                           ordered=True)
        return out

    monkeypatch.setattr(jengine, "budget_iters", spy)
    monkeypatch.setattr(jserver, "budget_iters", spy)
    return seen


def assert_matches_reference(got, jsrv, budgets=None, tol=TOL):
    """A port run's summary (``torch_shard_worker.summary``) against the
    finished reference server: cohorts, budgets, L/H/theta and the
    dropout/dropped/overflowed counters bitwise; the workload means within
    1e-6 relative (an ulp: another summation order); params, values and
    the losses within ``tol``."""
    np.testing.assert_array_equal(got["cohorts"], np.stack(jsrv.cohorts))
    if budgets is not None:
        np.testing.assert_array_equal(got["budgets"], np.stack(budgets))
    for name in ("L", "H", "theta"):
        np.testing.assert_array_equal(got[name], getattr(jsrv, name))
    np.testing.assert_allclose(got["values"], jsrv.values.v, rtol=tol,
                               atol=tol)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, np.asarray(jsrv.params[k]), rtol=tol,
                                   atol=tol)
    jh = jsrv.history
    for k in ("dropout", "dropped", "overflowed"):
        np.testing.assert_array_equal(got["history"][k], jh[k], err_msg=k)
    # means of the round's [K] float32 values: the reference's host driver
    # takes numpy's pairwise mean, the port's device round a torch sum
    for k in ("assigned", "uploaded", "true_workload"):
        np.testing.assert_allclose(got["history"][k], jh[k], rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["history"]["train_loss"],
                               jh["train_loss"], rtol=tol, atol=tol)


def assert_same_run(a, b):
    """Two port runs' summaries bitwise equal (every rank's too)."""
    for k in ("cohorts", "budgets", "L", "H", "theta", "values"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k],
                                      err_msg=k)
    for k in a["history"]:
        np.testing.assert_array_equal(a["history"][k], b["history"][k],
                                      err_msg=k)
