"""The port's two-layer tanh MLP step against the reference, on the same
numpy-made params and data.

Tolerances: loss and gradient 1e-6 (one forward and backward pass, sums
in another order).  One packed round with the reference's minibatch
draws injected: within 2e-5 of the reference's pallas round (the iid
round runs the dense kernel's plain version here, the reference its
Pallas kernel, both closed-form backprop); within the reference's own
MLP pallas-vs-xla bound, rtol 5e-4 and atol 5e-5, of its xla round
(autodiff there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.core import aggregation as jagg
from repro.core.engine import RoundEngine as JEngine
from repro.data.federated import make_femnist_like as jfemnist
from repro.models import fl_models as jfl
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core.engine import RoundEngine as TEngine
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.kernels.ops import FUSED_SGD_KINDS, fused_sgd_eligible
from repro_torch.models import fl_models as tfl
from torch_cases import one_torch_thread  # noqa: F401

B, MAX_ITERS, LR, HIDDEN = 4, 8, 0.05, 8
DS_KW = dict(n_clients=12, total=300, dim=16, max_size=24)


def _case(seed=0, n=9, d=12, H=6, C=5):
    rng = np.random.default_rng(seed)
    params = {"w1": rng.normal(scale=0.3, size=(d, H)).astype(np.float32),
              "b1": rng.normal(scale=0.1, size=H).astype(np.float32),
              "w2": rng.normal(scale=0.3, size=(H, C)).astype(np.float32),
              "b2": rng.normal(scale=0.1, size=C).astype(np.float32)}
    batch = {"x": rng.normal(size=(n, d)).astype(np.float32),
             "y": rng.integers(0, C, n).astype(np.int32),
             "mask": (np.arange(n) < n - 2).astype(np.float32)}
    return params, batch


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_grad_and_accuracy_match_reference(seed):
    params, batch = _case(seed)
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, batch)
    tp = params_from_reference(params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(tfl.mlp_loss(tp, tb)),
                               float(jfl.mlp_loss(jp, jb)), rtol=1e-6,
                               atol=1e-6)
    tg, jg = grad(tfl.mlp_loss)(tp, tb), jax.grad(jfl.mlp_loss)(jp, jb)
    for k in params:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=1e-6)
    assert float(tfl.mlp_accuracy(tp, tb)) == float(jfl.mlp_accuracy(jp, jb))


def test_make_mlp_and_resolution():
    ds = tfemnist(**DS_KW)
    step = tfl.resolve_local_step("mlp", ds)
    assert step.kind == "mlp"
    p = step.init_params(torch.Generator().manual_seed(0))
    assert list(p) == ["w1", "b1", "w2", "b2"]
    assert tuple(p["w1"].shape) == (16, 64) and tuple(p["b1"].shape) == (64,)
    assert tuple(p["w2"].shape) == (64, ds.n_classes)
    assert not p["b1"].any() and not p["b2"].any()
    # N(0, 1/fan_in) init, as the reference's
    assert abs(float(p["w1"].std()) - 16 ** -0.5) < 0.05
    small = tfl.make_mlp(16, 26, hidden=8).init_params(
        torch.Generator().manual_seed(0))
    assert tuple(small["w2"].shape) == (8, 26)


def test_params_from_reference_carries_the_four_leaves():
    jp = jfl.make_mlp(16, 26, hidden=8).init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    assert sorted(tp) == ["b1", "b2", "w1", "w2"]
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    back = params_to_numpy(tp)
    for k in jp:
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))


def test_fused_kind_table_matches_reference():
    from repro.kernels.ops import FUSED_SGD_KINDS as J_KINDS
    assert FUSED_SGD_KINDS == J_KINDS == ("mclr", "mlp")
    for step in (tfl.make_mclr(8, 3), tfl.make_mlp(8, 3)):
        assert fused_sgd_eligible(step, "iid")
        assert not fused_sgd_eligible(step, "shuffle")
    assert not fused_sgd_eligible(
        tfl.LocalStep(None, tfl.mlp_loss, kind=None), "iid")


@pytest.fixture(scope="module")
def fed():
    jds = jfemnist(**DS_KW)
    jmodel = jfl.make_mlp(16, jds.n_classes, hidden=HIDDEN)
    return dict(jds=jds, tds=tfemnist(**DS_KW), max_n=int(jds.sizes.max()),
                jmodel=jmodel, jparams=jmodel.init(jax.random.PRNGKey(7)),
                ids=np.array([0, 2, 4, 5, 9, 11]),
                n_iters=np.array([0, 1, 3, 8, 2, 7], np.int32),
                rng=jax.random.PRNGKey(3))


def _reference_round(c, sampling, backend, agg):
    eng = JEngine(lr=LR, aggregator=jagg.get_aggregator(agg), donate=False)
    fn = eng.make_packed_round(c["jmodel"], B, MAX_ITERS, c["max_n"],
                               sampling=sampling, backend=backend)
    pk = c["jds"].packed(c["max_n"])
    p, losses, up = fn(c["jparams"], pk.x, pk.y, pk.offsets, pk.lengths,
                       jnp.asarray(c["ids"], jnp.int32),
                       jnp.asarray(c["n_iters"]), c["rng"])
    return jax.tree.map(np.asarray, p), np.asarray(losses), bool(up)


def _port_round(c, sampling, agg):
    n = np.minimum(c["jds"].sizes[c["ids"]], c["max_n"])
    keys = jax.random.split(c["rng"], len(c["ids"]))
    if sampling == "iid":
        draws = np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
            k, (MAX_ITERS, B), 0, jnp.maximum(nk, 1)))(keys, jnp.asarray(n)))
    else:
        draws = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (c["max_n"],)))(keys))
    eng = TEngine(lr=LR, aggregator=tagg.get_aggregator(agg))
    fn = eng.make_packed_round(tfl.make_mlp(16, c["tds"].n_classes,
                                            hidden=HIDDEN),
                               B, MAX_ITERS, c["max_n"], sampling=sampling)
    pk = c["tds"].packed(c["max_n"], device="cpu")
    p, losses, up = fn(params_from_reference(
        jax.tree.map(np.asarray, c["jparams"]), "cpu"), pk.x, pk.y,
        pk.offsets, pk.lengths, torch.from_numpy(c["ids"]),
        torch.from_numpy(c["n_iters"]), draws=draws)
    return params_to_numpy(p), losses.numpy(), bool(up)


@pytest.mark.parametrize("sampling", ["iid", "shuffle"])
@pytest.mark.parametrize("agg", ["fedavg", "fedprox"])
@pytest.mark.parametrize("backend,rtol,atol", [("pallas", 2e-5, 2e-5),
                                               ("xla", 5e-4, 5e-5)])
def test_mlp_packed_round_matches_reference(fed, sampling, agg, backend,
                                            rtol, atol):
    ref = _reference_round(fed, sampling, backend, agg)
    port = _port_round(fed, sampling, agg)
    for k in ref[0]:
        np.testing.assert_allclose(port[0][k], ref[0][k], rtol=rtol,
                                   atol=atol)
    np.testing.assert_allclose(port[1], ref[1], rtol=rtol, atol=atol)
    assert port[2] == ref[2]
