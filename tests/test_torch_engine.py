"""Port engine: one packed round against the reference's ``make_packed_round``
with the same cohort, budgets, init params and minibatch draws.

Torch cannot reproduce the reference's threefry bits, so the test
recomputes the reference's draws in JAX (the same ``split``/``randint``/
``uniform`` calls its round makes) and hands them to the port through
``draws=``.  Tolerance 2e-5 (rtol and atol): the local-SGD bound of the
reference's own kernel-vs-XLA contract.  ``budget_iters`` is bitwise;
FedAvg/FedProx on fixed stacks within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.engine import RoundEngine as JEngine
from repro.core.engine import budget_iters as jbudget
from repro.data.federated import make_femnist_like as jfemnist
from repro.models.fl_models import make_mclr as jmclr
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core.engine import RoundEngine as TEngine
from repro_torch.core.engine import budget_iters as tbudget
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.models.fl_models import LocalStep, make_mclr, mclr_loss
from torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-5
B, MAX_ITERS, LR = 4, 12, 0.05
DS_KW = dict(n_clients=12, total=300, dim=16, max_size=24)


@pytest.fixture(scope="module")
def case():
    jds = jfemnist(**DS_KW)
    max_n = int(jds.sizes.max())
    jmodel = jmclr(16, jds.n_classes)
    jparams = jmodel.init(jax.random.PRNGKey(7))
    ids = np.array([0, 2, 4, 5, 9, 11])
    n_iters = np.array([0, 1, 3, 12, 2, 7], np.int32)
    return dict(jds=jds, tds=tfemnist(**DS_KW), max_n=max_n, jmodel=jmodel,
                jparams=jparams, ids=ids, n_iters=n_iters,
                rng=jax.random.PRNGKey(3))


def reference_draws(rng, n, sampling, max_n):
    """The minibatch draws the reference's round makes from ``rng``."""
    keys = jax.random.split(rng, n.shape[0])
    if sampling == "iid":
        return np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
            k, (MAX_ITERS, B), 0, jnp.maximum(nk, 1)))(keys,
                                                       jnp.asarray(n)))
    return np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (max_n,)))(keys))


def _reference_round(c, sampling, backend, aggregator):
    eng = JEngine(lr=LR, aggregator=aggregator, donate=False)
    fn = eng.make_packed_round(c["jmodel"], B, MAX_ITERS, c["max_n"],
                               sampling=sampling, backend=backend)
    pk = c["jds"].packed(c["max_n"])
    p, losses, up = fn(c["jparams"], pk.x, pk.y, pk.offsets, pk.lengths,
                       jnp.asarray(c["ids"], jnp.int32),
                       jnp.asarray(c["n_iters"]), c["rng"])
    return jax.tree.map(np.asarray, p), np.asarray(losses), bool(up)


def _port_round(c, sampling, aggregator, model=None):
    n = np.minimum(c["jds"].sizes[c["ids"]], c["max_n"])
    draws = reference_draws(c["rng"], n, sampling, c["max_n"])
    eng = TEngine(lr=LR, aggregator=aggregator)
    model = model or make_mclr(16, c["tds"].n_classes)
    fn = eng.make_packed_round(model, B, MAX_ITERS, c["max_n"],
                               sampling=sampling)
    pk = c["tds"].packed(c["max_n"], device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, c["jparams"]),
                                   "cpu")
    p, losses, up = fn(params, pk.x, pk.y, pk.offsets, pk.lengths,
                       torch.from_numpy(c["ids"]),
                       torch.from_numpy(c["n_iters"]), draws=draws)
    return params_to_numpy(p), losses.numpy(), bool(up)


def _assert_close(port, ref):
    for k in ref[0]:
        np.testing.assert_allclose(port[0][k], ref[0][k], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port[1], ref[1], rtol=TOL, atol=TOL)
    assert port[2] == ref[2]


@pytest.mark.parametrize("sampling,backend,agg", [
    ("iid", "xla", "fedavg"),
    ("iid", "pallas", "fedavg"),
    ("iid", "pallas", "fedprox"),
    ("shuffle", "xla", "fedavg"),
    ("shuffle", "pallas", "fedprox"),
])
def test_packed_round_matches_reference(case, sampling, backend, agg):
    ref = _reference_round(case, sampling, backend,
                           jagg.get_aggregator(agg))
    port = _port_round(case, sampling, tagg.get_aggregator(agg))
    _assert_close(port, ref)


def test_generic_iid_path_matches_reference(case):
    """A step the fused kernel does not cover (kind=None) takes the plain
    vmap/autodiff iid loop; it must match the reference's XLA iid round."""
    ref = _reference_round(case, "iid", "xla", jagg.FedAvg())
    step = LocalStep(init_params=None, loss=mclr_loss, kind=None)
    port = _port_round(case, "iid", tagg.FedAvg(), model=step)
    _assert_close(port, ref)


def test_round_draws_from_generator_without_injection(case):
    eng = TEngine(lr=LR)
    pk = case["tds"].packed(case["max_n"], device="cpu")
    params = params_from_reference(
        jax.tree.map(np.asarray, case["jparams"]), "cpu")
    for sampling in ("iid", "shuffle"):
        fn = eng.make_packed_round(make_mclr(16, 26), B, MAX_ITERS,
                                   case["max_n"], sampling=sampling)
        outs = [fn(params, pk.x, pk.y, pk.offsets, pk.lengths,
                   torch.from_numpy(case["ids"]),
                   torch.from_numpy(case["n_iters"]),
                   gen=torch.Generator().manual_seed(5))
                for _ in range(2)]
        for k in params:     # same seed -> same round
            assert torch.equal(outs[0][0][k], outs[1][0][k])
        assert torch.isfinite(outs[0][1]).all()


def test_budget_iters_bitwise():
    rng = np.random.default_rng(4)
    e = np.r_[rng.uniform(0, 24, 200), [0.5, 1.5, 2.5, 0.25, 0.0]]
    n = np.r_[rng.integers(0, 400, 200), [10, 10, 10, 4, 7]]
    for max_iters in (960, 37):
        want = np.asarray(jbudget(e, n, 10, max_iters))
        got = tbudget(e, n, 10, max_iters).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
@pytest.mark.parametrize("weights", [[3.0, 0.0, 7.0, 1.0],
                                     [0.0, 0.0, 0.0, 0.0]])
def test_aggregators_on_fixed_stacks(name, weights):
    rng = np.random.default_rng(5)
    stack = {"w": rng.normal(size=(4, 6, 3)).astype(np.float32),
             "b": rng.normal(size=(4, 3)).astype(np.float32)}
    glob = {"w": rng.normal(size=(6, 3)).astype(np.float32),
            "b": rng.normal(size=3).astype(np.float32)}
    w = np.asarray(weights, np.float32)
    want = jagg.get_aggregator(name)(
        jax.tree.map(jnp.asarray, stack), jax.tree.map(jnp.asarray, glob),
        jnp.asarray(w))
    got = tagg.get_aggregator(name)(
        {k: torch.from_numpy(v) for k, v in stack.items()},
        {k: torch.from_numpy(v) for k, v in glob.items()},
        torch.from_numpy(w))
    for k in glob:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    assert tagg.get_aggregator("fedprox", prox_mu=0.3).prox_mu == 0.3
