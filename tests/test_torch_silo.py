"""The port's cross-silo FedSAE (``RoundEngine.make_stream_round``,
``core.silo``) against the reference, on the CPU.

- The stream round: the reference test's masked-steps equivalence (a
  budget of n steps out of a longer stream equals a stream of n steps) and
  zero-weight round, then the same round as the reference's on the same
  batches, with per-silo budgets and FedProx, within 2e-5 (the local-SGD
  contract).
- ``SiloFedSAE``: 2 rounds on the float32 smoke Llama from the reference's
  init (``init_params=``): L, H and the step budgets bitwise (the host
  algebra is the reference's numpy), per-round losses and the final global
  params within 2e-5.
- ``SiloFedSAE(sink=)`` is accepted and emits a record a round; the
  upload screen (``screen_norm=``) runs, and a bound no upload meets
  leaves the global params as they were.
- The ``fl_train --silo-arch`` CLI on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.engine import RoundEngine as JRoundEngine
from repro.core.aggregation import get_aggregator as jget_aggregator
from repro.core.silo import SiloFedSAE as JSiloFedSAE
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core.aggregation import get_aggregator
from repro_torch.core.engine import RoundEngine
from repro_torch.core.silo import SiloFedSAE, make_silo_round_fn
from repro_torch.launch import fl_train
from repro_torch.models.api import build_model
from repro_torch.models.fl_models import LocalStep
from repro_torch.obs import RingBufferSink
from repro_torch.tree import tree_leaves
from torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-5


def _quad(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def _jquad(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def _stream(K=1, steps=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(K, steps, 8, 4)).astype(np.float32),
            "y": rng.normal(size=(K, steps, 8, 2)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_stream_round_masked_steps_equal_fewer_steps():
    """n_steps masking == literally fewer steps (the reference test)."""
    p0 = {"w": torch.ones((4, 2))}
    b = _stream()
    w = torch.ones(1)
    pa, la = make_silo_round_fn(_quad, 0.05, max_steps=6)(
        p0, _t(b), torch.tensor([3]), w)
    pb, lb = make_silo_round_fn(_quad, 0.05, max_steps=3)(
        p0, _t({k: v[:, :3] for k, v in b.items()}), torch.tensor([3]), w)
    np.testing.assert_allclose(pa["w"].numpy(), pb["w"].numpy(), atol=1e-6)
    assert float(la[0]) == float(lb[0])
    assert torch.equal(p0["w"], torch.ones((4, 2)))     # global untouched


def test_stream_round_zero_weight_keeps_global():
    p0 = {"w": torch.ones((4, 2))}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 4, 8, 4)).astype(np.float32))
    fn = make_silo_round_fn(lambda p, b: torch.mean((b["x"] @ p["w"]) ** 2),
                            0.1, max_steps=4)
    p1, _ = fn(p0, {"x": x}, torch.tensor([4, 4]), torch.zeros(2))
    np.testing.assert_allclose(p1["w"].numpy(), p0["w"].numpy())


@pytest.mark.parametrize("aggregator,kw", [("fedavg", {}),
                                           ("fedprox", {"prox_mu": 0.3})])
def test_stream_round_matches_reference(aggregator, kw):
    """K = 3 silos with budgets 5, 0 and 2 of 5 steps; weights by size
    (0 for the silo that trained nothing)."""
    p0 = {"w": np.random.default_rng(7).normal(size=(4, 2)).astype(
        np.float32)}
    b = _stream(K=3, steps=5, seed=8)
    n_steps = np.array([5, 0, 2], np.int32)
    weights = np.array([300.0, 0.0, 120.0], np.float32)
    jeng = JRoundEngine(lr=0.05, aggregator=jget_aggregator(aggregator,
                                                            **kw))
    jnew, jloss = jeng.make_stream_round(_jquad, 5)(
        jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, b),
        jnp.asarray(n_steps), jnp.asarray(weights))
    teng = RoundEngine(lr=0.05, aggregator=get_aggregator(aggregator, **kw))
    new, loss = teng.make_stream_round(_quad, 5)(
        _t(p0), _t(b), torch.from_numpy(n_steps), torch.from_numpy(weights))
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=TOL,
                               rtol=TOL)
    assert float(loss[1]) == 0.0


def test_stream_round_refuses_compression():
    with pytest.raises(ValueError, match="compression"):
        RoundEngine(lr=0.1, compress="topk_q8").make_stream_round(_quad, 2)


def test_per_layer_leaves_train_like_the_stacked_leaves():
    """Training the per-layer views (``leaf_views``) of the stacked blocks
    gives exactly the stacked leaves' result: their gradients are the same
    numbers without the zero fill."""
    cfg = get_config("llama3.2-3b", smoke=True).replace(dtype="float32")
    tm = build_model(cfg)
    p0 = tm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2, 2, 16))
                            .astype(np.int32))
    batches = {"tokens": toks, "labels": toks}
    loss = lambda p, b: tm.train_loss(p, b)[0]
    out = []
    for views in (None, tm.leaf_views):
        step = LocalStep(tm.init, loss, leaf_views=views)
        fn = RoundEngine(lr=5e-3).make_stream_round(step, 2)
        out.append(fn(p0, batches, torch.tensor([2, 1]),
                      torch.tensor([1.0, 3.0])))
    (a, la), (b, lb) = out
    assert torch.equal(la, lb)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a), tree_leaves(p0)):
        assert x.shape == y.shape and not x.requires_grad


def test_silo_fedsae_matches_reference():
    jcfg = jget_config("llama3.2-3b", smoke=True).replace(dtype="float32")
    tcfg = get_config("llama3.2-3b", smoke=True).replace(dtype="float32")
    K, max_steps, S = 2, 4, 24
    jfed = JSiloFedSAE(jbuild_model(jcfg), K, lr=5e-3, max_steps=max_steps)
    budgets = []
    inner = jfed.round_fn

    def capture(params, batches, n_steps, weights):
        budgets.append(np.asarray(n_steps))
        return inner(params, batches, n_steps, weights)

    jfed.round_fn = capture
    tfed = SiloFedSAE(build_model(tcfg), K, lr=5e-3, max_steps=max_steps,
                      init_params=jax.tree.map(np.asarray, jfed.params),
                      device="cpu")
    ri = np.random.default_rng(0)
    sizes = np.asarray(ri.integers(100, 1000, K))
    for r in range(2):
        toks = fl_train.silo_tokens(ri, tcfg, K, max_steps, S=S)
        jstats = jfed.run_round({"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(toks)}, sizes)
        tstats = tfed.run_round({"tokens": toks, "labels": toks}, sizes)
        assert np.array_equal(tfed.last_n_steps, budgets[-1])
        assert np.array_equal(tfed.L, jfed.L)
        assert np.array_equal(tfed.H, jfed.H)
        np.testing.assert_allclose(tstats["loss"][-1], jstats["loss"][-1],
                                   atol=TOL, rtol=TOL)
        assert tstats["dropout"] == jstats["dropout"]
        assert tstats["uploaded_steps"] == jstats["uploaded_steps"]
    assert sum(int(b.sum()) for b in budgets) > 0
    want = jax.tree.map(np.asarray, jfed.params)
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(
               jax.tree.map(lambda t: t.numpy(), tfed.params))[0]}
    for k, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_allclose(got[jax.tree_util.keystr(k)], w,
                                   atol=TOL, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(k))


def test_silo_fedsae_refuses_unported_features():
    cfg = get_config("llama3.2-3b", smoke=True)
    ring = RingBufferSink()             # a sink is accepted (A10 is in)
    fed = SiloFedSAE(build_model(cfg), 2, max_steps=2, device="cpu",
                     sink=ring)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 2, 16)).astype(np.int32)
    fed.run_round({"tokens": toks, "labels": toks}, np.array([100, 500]))
    assert len(ring) == 1 and ring.last.train_loss == fed.stats["loss"][-1]
    # the upload screen (once refused, ROADMAP A9) runs: a bound no
    # upload meets rejects every uploading silo, and the round leaves the
    # global params as they were
    screened = SiloFedSAE(build_model(cfg), 2, max_steps=2, device="cpu",
                          screen_norm=1e-12, sink=ring)
    before = [t.clone() for t in tree_leaves(screened.params)]
    screened.run_round({"tokens": toks, "labels": toks},
                       np.array([100, 500]))
    assert ring.last.screened == float((screened.last_n_steps > 0).sum())
    for a, b in zip(before, tree_leaves(screened.params)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        SiloFedSAE(object(), 2, device="cpu")


def test_fl_train_silo_cli_runs_on_the_cpu(capsys):
    fed = fl_train.main(["--silo-arch", "llama3.2-3b", "--silos", "2",
                         "--rounds", "1", "--max-steps", "2", "--device",
                         "cpu"])
    out = capsys.readouterr().out
    assert "round 0: loss=" in out and "silo FL done" in out
    assert fed.K == 2 and np.isfinite(fed.stats["loss"][-1])
    assert all(t.device.type == "cpu" for t in tree_leaves(fed.params))
