"""The port's robust aggregation registry against the reference's, on the
same numpy-made stacks.

Tolerances: 1e-6 (rtol and atol) for the rank-based aggregators
(trimmed_mean, median, krum, bulyan: a sort, then a sum of at most K
values in another order) and 1e-5 for the geometric median (eight
Weiszfeld steps, each a distance summed over every coordinate).  Krum's and
Bulyan's chosen clients must be identical.  Their scores sum Gram-form
distances in another order than XLA's, so the stacks keep every two
scores apart (the far-out row and the clusters below); the one tie case
ties exactly, where a stable argsort must take the lower index.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.engine import RoundEngine as JEngine
from repro.data.federated import make_femnist_like as jfemnist
from repro.models.fl_models import make_mclr as jmclr
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core.engine import RoundEngine as TEngine
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.models.fl_models import make_mclr
from torch_cases import one_torch_thread  # noqa: F401

RANK_TOL, GM_TOL = 1e-6, 1e-5
ROBUST = ("trimmed_mean", "median", "krum", "geometric_median", "bulyan")
#: the keyword arguments each case gives the aggregator (krum and bulyan
#: with one assumed byzantine upload, multi-Krum averaging two)
KW = {"trimmed_mean": dict(trim_ratio=0.2), "median": {},
      "krum": dict(n_byzantine=1, multi=2),
      "geometric_median": {}, "bulyan": dict(n_byzantine=1)}


def _tol(name):
    return GM_TOL if name == "geometric_median" else RANK_TOL


def _stack(seed=0, K=9):
    """K clients' {"w": [6, 3], "b": [3]} uploads around a common centre,
    each at its own distance from it (so no two Krum scores tie), one
    far-out adversarial row (client 4) and one dropped client (weight 0,
    client 7); the global and the weights (n_k) in [1, 50)."""
    rng = np.random.default_rng(seed)
    centre = {"w": rng.normal(size=(6, 3)), "b": rng.normal(size=3)}
    spread = np.linspace(0.05, 0.6, K)[rng.permutation(K)]
    stack = {k: np.stack([v + s * rng.normal(size=v.shape)
                          for s in spread]).astype(np.float32)
             for k, v in centre.items()}
    stack["w"][4] += 1e3
    stack["b"][4] -= 1e3
    glob = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in centre.items()}
    w = rng.integers(1, 50, K).astype(np.float32)
    w[7] = 0.0
    return stack, glob, w


def _both(name, stack, glob, w, **kw):
    want = jagg.get_aggregator(name, **kw)(
        jax.tree.map(jnp.asarray, stack), jax.tree.map(jnp.asarray, glob),
        jnp.asarray(w))
    got = tagg.get_aggregator(name, **kw)(
        params_from_reference(stack, "cpu"),
        params_from_reference(glob, "cpu"), torch.from_numpy(w))
    return params_to_numpy(got), jax.tree.map(np.asarray, want)


def _assert_close(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_close(got[k], want[k], tol)
            continue
        assert got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol)


def _reference_chosen(name, stack, w, n_byzantine, multi=1):
    """The clients the reference's Krum / Bulyan keep: its scores, its
    stable argsort, its q."""
    flat = jagg._flatten_clients(jax.tree.map(jnp.asarray, stack))
    scores, m = jagg._krum_scores(flat, jnp.asarray(w) > 0, n_byzantine)
    order = np.asarray(jnp.argsort(scores))
    m = int(m)
    q = (min(multi, max(m, 1)) if name == "krum"
         else int(np.clip(m - 2 * n_byzantine, 1, max(m, 1))))
    return set(order[:q].tolist())


def _port_chosen(name, stack, w, **kw):
    flat = tagg._flatten_clients(params_from_reference(stack, "cpu"))
    agg = tagg.get_aggregator(name, **kw)
    mask = agg.select(flat, torch.from_numpy(w))
    return set(np.flatnonzero(mask.numpy()).tolist())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ROBUST)
def test_matches_reference_on_a_stack_with_an_adversary(name, weighted):
    stack, glob, w = _stack()
    got, want = _both(name, stack, glob, w, weighted=weighted, **KW[name])
    _assert_close(got, want, _tol(name))
    if name in ("trimmed_mean", "median", "krum", "bulyan"):
        # the far-out upload never reaches the statistic
        assert np.abs(got["w"]).max() < 100


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", ["krum", "bulyan"])
def test_chosen_clients_equal_the_reference(name, seed):
    stack, _, w = _stack(seed)
    kw = dict(KW[name])
    assert _port_chosen(name, stack, w, **kw) == _reference_chosen(
        name, stack, w, **kw)


@pytest.mark.parametrize("name", ROBUST)
def test_empty_round_keeps_the_global(name):
    stack, glob, w = _stack(3)
    got, want = _both(name, stack, glob, np.zeros_like(w), **KW[name])
    _assert_close(got, want, 0.0)
    for k in glob:
        np.testing.assert_array_equal(got[k], glob[k])


@pytest.mark.parametrize("name", ROBUST)
def test_invalid_clients_are_ignored(name):
    """A weight-0 row of 1e9 gives exactly what the stack without it
    gives."""
    stack, glob, w = _stack(4)
    stack = {k: v.copy() for k, v in stack.items()}
    for v in stack.values():
        v[7] = 1e9
    got, want = _both(name, stack, glob, w, **KW[name])
    _assert_close(got, want, _tol(name))
    keep = np.flatnonzero(w > 0)
    alone, _ = _both(name, {k: v[keep] for k, v in stack.items()}, glob,
                     w[keep], **KW[name])
    for k in glob:
        np.testing.assert_allclose(got[k], alone[k], rtol=_tol(name),
                                   atol=_tol(name))


@pytest.mark.parametrize("name", ROBUST)
def test_weighted_false_is_bitwise_the_unweighted_aggregator(name):
    stack, glob, w = _stack(5)
    base = tagg.get_aggregator(name, **KW[name])
    off = tagg.get_aggregator(name, weighted=False, **KW[name])
    args = (params_from_reference(stack, "cpu"),
            params_from_reference(glob, "cpu"), torch.from_numpy(w))
    for k, v in base(*args).items():
        assert torch.equal(off(*args)[k], v)


def test_weighted_trimmed_mean_tie_needs_a_stable_sort():
    """Values [1, 1, 2, 9] with n_k [1, 5, 1, 1], one trimmed per end: the
    band is rank 1 (a tied 1) and rank 2.  A stable sort keeps the tied
    clients in index order, so rank 1 carries client 1's n_k = 5: (5 * 1 +
    1 * 2) / 6.  Rank 1 taken from client 0 would give 1.5."""
    stack = {"w": np.array([[1.0], [1.0], [2.0], [9.0]], np.float32)}
    glob = {"w": np.zeros(1, np.float32)}
    w = np.array([1.0, 5.0, 1.0, 1.0], np.float32)
    got, want = _both("trimmed_mean", stack, glob, w, trim_ratio=0.25,
                      weighted=True)
    np.testing.assert_allclose(want["w"], [7.0 / 6.0], rtol=RANK_TOL)
    _assert_close(got, want, RANK_TOL)


@pytest.mark.parametrize("name", ["krum", "bulyan"])
def test_tied_scores_choose_the_lower_index(name):
    """Clients 1 and 3 upload the same vector, so their Krum scores tie
    exactly; the stable argsort keeps client 1 first, and invalid clients
    (score _FAR) rank last in index order."""
    stack = {"w": np.array([[0.0, 3.0], [1.0, 1.0], [4.0, 0.0], [1.0, 1.0],
                            [2.0, 2.0], [50.0, 50.0], [7.0, 7.0]],
                           np.float32)}
    glob = {"w": np.zeros(2, np.float32)}
    w = np.array([1, 1, 1, 1, 1, 1, 0], np.float32)
    kw = dict(n_byzantine=1) if name == "bulyan" else dict(n_byzantine=1,
                                                           multi=1)
    assert _port_chosen(name, stack, w, **kw) == _reference_chosen(
        name, stack, w, **kw)
    if name == "krum":
        assert _port_chosen(name, stack, w, **kw) == {1}
    got, want = _both(name, stack, glob, w, **kw)
    _assert_close(got, want, RANK_TOL)


def test_small_cohorts_and_a_single_upload():
    """m = 1 returns the sole upload for every rank-based aggregator (its
    Krum score must not tie the sentinels); K = 1 works at m = 0 and 1."""
    stack = {"w": np.array([[1e9], [1.0], [-7.0]], np.float32)}
    glob = {"w": np.zeros(1, np.float32)}
    w = np.array([0.0, 1.0, 0.0], np.float32)
    for name in ROBUST:
        got, want = _both(name, stack, glob, w, **KW[name])
        _assert_close(got, want, _tol(name))
        np.testing.assert_allclose(got["w"], [1.0], atol=_tol(name))
    one = {"w": np.array([[3.0, -2.0]], np.float32)}
    g1 = {"w": np.array([0.5, 0.5], np.float32)}
    for name in ROBUST:
        for wt in (0.0, 4.0):
            got, want = _both(name, one, g1, np.array([wt], np.float32),
                              **KW[name])
            _assert_close(got, want, _tol(name))


@pytest.mark.parametrize("name", ROBUST)
def test_nested_trees_flatten_in_the_reference_order(name):
    """A nested params tree (the silo round's LMs): leaves in sorted-key
    order at every level, the result shaped like the global."""
    stack, glob, w = _stack(6)
    nest = {"z": {"b": stack["b"]}, "a": {"w": stack["w"],
                                          "c": stack["b"] * 2}}
    gnest = {"z": {"b": glob["b"]}, "a": {"w": glob["w"], "c": glob["b"]}}
    got, want = _both(name, nest, gnest, w, **KW[name])
    _assert_close(got, want, _tol(name))


@pytest.mark.parametrize("make", [
    lambda m: m.Krum(n_byzantine=-1), lambda m: m.Krum(multi=0),
    lambda m: m.GeometricMedian(iters=0), lambda m: m.Bulyan(n_byzantine=-1),
    lambda m: m.TrimmedMean(trim_count=-1),
    lambda m: m.TrimmedMean(trim_ratio=0.5)])
def test_argument_checks_match_the_reference(make):
    with pytest.raises(ValueError):
        make(jagg)
    with pytest.raises(ValueError):
        make(tagg)


def test_registry_names_and_kwargs():
    assert list(tagg.AGGREGATORS) == list(jagg.AGGREGATORS)
    with pytest.raises(ValueError, match="unknown aggregator"):
        tagg.get_aggregator("mean_of_medians")
    b = tagg.get_aggregator("bulyan", n_byzantine=1, weighted=True)
    assert isinstance(b, tagg.Bulyan) and b._inner.trim_count == 1
    for name in ROBUST:
        assert tagg.get_aggregator(name).prox_mu == 0.0


B, MAX_ITERS, LR = 4, 12, 0.05
DS_KW = dict(n_clients=12, total=300, dim=16, max_size=24)


@pytest.mark.parametrize("name", ["krum", "bulyan", "geometric_median"])
def test_packed_round_with_a_robust_aggregator_matches_reference(name):
    """One iid MCLR round inside each engine with the same cohort, budgets,
    init and minibatch draws: the local SGD contributes its 2e-5."""
    jds, tds = jfemnist(**DS_KW), tfemnist(**DS_KW)
    max_n = int(jds.sizes.max())
    ids = np.array([0, 2, 4, 5, 9, 11])
    n_iters = np.array([0, 1, 3, 12, 2, 7], np.int32)
    kw = dict(n_byzantine=1) if name != "geometric_median" else {}
    jparams = jmclr(16, jds.n_classes).init(jax.random.PRNGKey(7))
    rng = jax.random.PRNGKey(3)
    pk = jds.packed(max_n)
    jp, jl, _ = JEngine(lr=LR, aggregator=jagg.get_aggregator(name, **kw),
                        donate=False).make_packed_round(
        jmclr(16, jds.n_classes), B, MAX_ITERS, max_n, sampling="iid")(
        jparams, pk.x, pk.y, pk.offsets, pk.lengths,
        jnp.asarray(ids, jnp.int32), jnp.asarray(n_iters), rng)
    n = np.minimum(jds.sizes[ids], max_n)
    draws = np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
        k, (MAX_ITERS, B), 0, jnp.maximum(nk, 1)))(
        jax.random.split(rng, len(ids)), jnp.asarray(n)))
    tpk = tds.packed(max_n, device="cpu")
    tp, tl, _ = TEngine(lr=LR, aggregator=tagg.get_aggregator(name, **kw)
                        ).make_packed_round(
        make_mclr(16, tds.n_classes), B, MAX_ITERS, max_n, sampling="iid")(
        params_from_reference(jax.tree.map(np.asarray, jparams), "cpu"),
        tpk.x, tpk.y, tpk.offsets, tpk.lengths, torch.from_numpy(ids),
        torch.from_numpy(n_iters), draws=draws)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    _assert_close(params_to_numpy(tp), jax.tree.map(np.asarray, jp), 2e-5)


@pytest.mark.parametrize("name", ["fedavg", "fedprox"])
def test_leaves_past_the_gemm_limit_mix_client_by_client(name,
                                                         monkeypatch):
    """A leaf of ``GEMM_MAX`` elements or more (cuBLAS's bound on a
    product's dimensions) is mixed by one ``addcmul_`` a client: with the
    bound lowered to 10, ``w`` [6, 3] takes that path and ``b`` [3] the
    ``tensordot``; both hold the reference's FedAvg at 1e-6, an empty
    round keeps the global."""
    stack, glob, w = _stack(6)
    monkeypatch.setattr(tagg, "GEMM_MAX", 10)
    got, want = _both(name, stack, glob, w)
    _assert_close(got, want, RANK_TOL)
    got, _ = _both(name, stack, glob, np.zeros_like(w))
    for k in glob:
        np.testing.assert_array_equal(got[k], glob[k])
