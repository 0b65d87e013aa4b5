"""The seed interface's padded round (``core.rounds.make_round_fn`` over
``RoundEngine.make_padded_round``) against the reference's, on the CPU.

Both rounds take the same host-stacked clients, budgets and init params;
torch cannot replay the reference's threefry draws, so the reference's
(``split(rng, K)`` then ``randint`` iid / ``uniform`` shuffle per client)
are recomputed in JAX and handed to the port through ``draws=``.
Tolerances: params and losses 2e-5 (rtol and atol), the reference's
local-SGD kernel-vs-XLA bound; ``uploaded_any`` bitwise.  The port's
padded and packed rounds on the same draws are bitwise equal, as the
reference's are (``tests/test_engine.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import RoundEngine as JEngine
from repro.core.rounds import make_round_fn as jmake_round_fn
from repro.data.federated import make_femnist_like as jfemnist
from repro.faults import FaultModel as JFaultModel
from repro.models import fl_models as jfl
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.core.aggregation import FedAvg
from repro_torch.core.engine import RoundEngine
from repro_torch.core.rounds import make_round_fn
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.faults import FaultModel
from repro_torch.models import fl_models as tfl
from torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-5
LR, B, MAX_ITERS = 0.05, 10, 12
DS_KW = dict(n_clients=20, total=1200, dim=16, max_size=60)
IDS = np.array([0, 3, 5, 6, 9, 11, 14, 17, 18, 19])
N_ITERS = np.array([0, 1, 2, 3, 4, 5, 6, 0, 8, 9], np.int32)
STEPS = {"mclr": lambda m, C: m.make_mclr(16, C),
         "mlp": lambda m, C: m.make_mlp(16, C, hidden=8)}


@pytest.fixture(scope="module")
def case():
    """The reference's ``flat_round_case``: 10 clients of a 20-client
    federation, budgets 0-9 (two of them 0), PRNGKey(3) for the round."""
    jds = jfemnist(**DS_KW)
    max_n = int(jds.sizes.max())
    return dict(jds=jds, tds=tfemnist(**DS_KW), max_n=max_n,
                stacked=jds.stacked(IDS, max_n), rng=jax.random.PRNGKey(3))


def reference_draws(rng, n, sampling, max_n, max_iters=MAX_ITERS, B=B):
    """The draws the reference's padded round makes from ``rng``."""
    keys = jax.random.split(rng, len(n))
    if sampling == "iid":
        return np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
            k, (max_iters, B), 0, jnp.maximum(nk, 1)))(
            keys, jnp.asarray(n, jnp.int32)))
    return np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (max_n,)))(keys))


def _pair(name, n_classes, seed=7):
    """The reference's step and init, and the port's step on that init."""
    jstep = STEPS[name](jfl, n_classes)
    jp = jstep.init(jax.random.PRNGKey(seed))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    return jstep, jp, STEPS[name](tfl, n_classes), tp


def _assert_close(got, want, tol=TOL):
    gp = params_to_numpy(got[0])
    for k, w in jax.tree.map(np.asarray, want[0]).items():
        np.testing.assert_allclose(gp[k], w, rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=tol, atol=tol)
    assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("name,sampling,prox_mu,backend", [
    ("mclr", "shuffle", 0.0, "xla"),
    ("mclr", "iid", 0.0, "xla"),
    ("mclr", "iid", 0.1, "pallas"),
    ("mlp", "shuffle", 0.0, "xla"),
    ("mlp", "iid", 0.0, "pallas"),
    ("mlp", "iid", 0.1, "xla"),
])
def test_engine_padded_round_matches_legacy(case, name, sampling, prox_mu,
                                            backend):
    """``make_round_fn`` against the reference's on the same stacked
    clients, init and draws; the fused iid steps (MCLR, the MLP) take
    their kernels' plain versions here."""
    jstep, jp, step, tp = _pair(name, case["jds"].n_classes)
    x, y, mask, n = case["stacked"]
    want = jmake_round_fn(jstep, LR, B, MAX_ITERS, prox_mu=prox_mu,
                          sampling=sampling, backend=backend)(
        jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        jnp.asarray(n, jnp.int32), jnp.asarray(N_ITERS), case["rng"])
    fn = make_round_fn(step, LR, B, MAX_ITERS, prox_mu=prox_mu,
                       sampling=sampling, backend=backend)
    got = fn(tp, x, y, mask, n, N_ITERS,
             draws=reference_draws(case["rng"], n, sampling, case["max_n"]))
    _assert_close(got, want)


@pytest.mark.parametrize("name,sampling", [("mclr", "shuffle"),
                                           ("mclr", "iid"),
                                           ("mlp", "iid")])
def test_engine_packed_round_matches_padded(case, name, sampling):
    """The packed round (device gather) and the padded round (host
    restack) on the same draws: bitwise, as in the reference."""
    _, _, step, tp = _pair(name, case["jds"].n_classes)
    x, y, mask, n = case["stacked"]
    eng = RoundEngine(lr=LR, aggregator=FedAvg(), donate=False)
    draws = reference_draws(case["rng"], n, sampling, case["max_n"])
    pa = eng.make_padded_round(step, B, MAX_ITERS, sampling=sampling)(
        tp, x, y, mask, n, N_ITERS, draws=draws)
    pk = case["tds"].packed(case["max_n"], device="cpu")
    pb = eng.make_packed_round(step, B, MAX_ITERS, case["max_n"],
                               sampling=sampling)(
        tp, pk.x, pk.y, pk.offsets, pk.lengths, torch.from_numpy(IDS),
        torch.from_numpy(N_ITERS), draws=draws)
    for k in tp:
        assert torch.equal(pa[0][k], pb[0][k]), k
    assert torch.equal(pa[1], pb[1]) and bool(pa[2]) == bool(pb[2])


def test_padded_round_draws_from_a_generator(case):
    """Without ``draws`` the round draws from ``gen`` (the port's
    streams): the same seed gives the same round; no source raises."""
    _, _, step, tp = _pair("mclr", case["jds"].n_classes)
    x, y, mask, n = case["stacked"]
    for sampling in ("iid", "shuffle"):
        fn = make_round_fn(step, LR, B, MAX_ITERS, sampling=sampling)
        a, b = (fn(tp, x, y, mask, n, N_ITERS,
                   gen=torch.Generator().manual_seed(5)) for _ in range(2))
        for k in tp:
            assert torch.equal(a[0][k], b[0][k])
        assert torch.isfinite(a[1]).all() and bool(a[2])
        with pytest.raises(ValueError, match="gen= or draws="):
            fn(tp, x, y, mask, n, N_ITERS)


@pytest.mark.parametrize("sampling", ["shuffle", "iid"])
def test_masked_iterations_equal_unmasked_shorter_run(sampling):
    """n_iters masking equals literally running fewer iterations (the
    reference's substrate test, here with iid too), and the long run
    matches the reference's."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 40, 8)).astype(np.float32)
    y = rng.integers(0, 3, (1, 40)).astype(np.int32)
    jstep, step = jfl.make_mclr(8, 3), tfl.make_mclr(8, 3)
    jp = jstep.init(jax.random.PRNGKey(1))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    mask = np.ones((1, 40), np.float32)
    n, it = np.array([40], np.int32), np.array([8])
    key = jax.random.PRNGKey(0)
    d20 = reference_draws(key, n, sampling, 40, max_iters=20)
    d8 = d20[:, :8] if sampling == "iid" else d20
    pa = make_round_fn(step, 0.05, 10, max_iters=20, sampling=sampling)(
        tp, x, y, mask, n, it, draws=d20)
    pb = make_round_fn(step, 0.05, 10, max_iters=8, sampling=sampling)(
        tp, x, y, mask, n, it, draws=d8)
    for k in tp:
        np.testing.assert_allclose(pa[0][k].numpy(), pb[0][k].numpy(),
                                   atol=1e-6)
    want = jmake_round_fn(jstep, 0.05, 10, max_iters=20, sampling=sampling)(
        jp, x, y, mask, n, it, key)
    _assert_close(pa, want)


def test_aggregation_weights_by_samples_and_uploads():
    """A client with no budget leaves the aggregate exactly as if it were
    absent; the mixed round matches the reference's."""
    jstep, step = jfl.make_mclr(4, 2), tfl.make_mclr(4, 2)
    jp = jstep.init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    fn = make_round_fn(step, 0.1, 2, max_iters=4)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 4)).astype(np.float32)
    y = rng.integers(0, 2, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.float32)
    n = np.array([10, 10], np.int32)
    it = np.array([4, 0], np.int32)
    key = jax.random.PRNGKey(2)
    draws = reference_draws(key, n, "shuffle", 10)
    p_mixed = fn(tp, x, y, mask, n, it, draws=draws)
    p_only0 = fn(tp, x[:1], y[:1], mask[:1], n[:1], it[:1],
                 draws=draws[:1])
    for k in tp:
        np.testing.assert_allclose(p_mixed[0][k].numpy(),
                                   p_only0[0][k].numpy(), atol=1e-6)
    want = jmake_round_fn(jstep, 0.1, 2, max_iters=4)(
        jp, x, y, mask, n, it, key)
    _assert_close(p_mixed, want)
    # every budget 0: nothing uploads and the params stay
    none = fn(tp, x, y, mask, n, np.array([0, 0], np.int32), draws=draws)
    assert not bool(none[2])
    for k in tp:
        assert torch.equal(none[0][k], tp[k])


def test_padded_round_refusals_and_engine_keywords():
    """The reference's three refusals, word for word, and the
    constructor keywords ``donate``, ``backend`` and ``fused_generic``."""
    step = tfl.make_mclr(4, 2)
    cases = [(dict(compress="topk_q8"), "upload compression"),
             (dict(faults=FaultModel(corrupt="nan", corrupt_prob=0.5)),
              "fault injection / upload screening"),
             (dict(screen_norm=1.0), "fault injection / upload screening")]
    jcases = [dict(compress="topk_q8"),
              dict(faults=JFaultModel(corrupt="nan", corrupt_prob=0.5)),
              dict(screen_norm=1.0)]
    for (kw, match), jkw in zip(cases, jcases):
        with pytest.raises(ValueError, match=match) as got:
            RoundEngine(0.1, **kw).make_padded_round(step, 2, 4)
        with pytest.raises(ValueError) as want:
            JEngine(0.1, **jkw).make_padded_round(jfl.make_mclr(4, 2), 2, 4)
        assert str(got.value) == str(want.value)
    eng = RoundEngine(0.1, donate=False, backend="pallas",
                      fused_generic=False)
    assert (eng.donate, eng.backend, eng.fused_generic) == (
        False, "pallas", False)
    assert RoundEngine(0.1).backend == "xla"
    with pytest.raises(ValueError, match="unknown backend"):
        RoundEngine(0.1, backend="tpu")
    with pytest.raises(ValueError, match="unknown backend"):
        JEngine(0.1, backend="tpu")
    with pytest.raises(ValueError, match="unknown backend"):
        RoundEngine(0.1).make_padded_round(step, 2, 4, backend="gpu")
    with pytest.raises(ValueError, match="unknown sampling"):
        RoundEngine(0.1).make_padded_round(step, 2, 4, sampling="none")
    with pytest.raises(TypeError, match="cannot interpret"):
        RoundEngine(0.1).make_padded_round(object(), 2, 4)
