"""The port's ``LocalStep`` protocol and its coercion (``as_local_step``)
against the reference's (``repro.models.fl_models``), and duck-typed
models through ``resolve_local_step``, ``RoundEngine`` and
``FedSAEServer``.

The protocol's values (``loss_and_grad``, ``local_sgd_step``) start from
the reference's params (``params_from_reference``) and agree within 1e-5
(float32, another summation order); the structure (``param_treedef``,
``n_params``) exactly, ``param_treedef`` being the reference's flatten
order.  A duck-typed model's round is bitwise its ``LocalStep``'s, and a
duck through ``FedSAEServer`` matches the reference's server with the
reference's duck, its draws injected, at the local-SGD bound 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FedSAEServer as JServer
from repro.core import ServerConfig as JConfig
from repro.data.federated import make_femnist_like as jfemnist
from repro.models import fl_models as jfl
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.core.engine import RoundEngine
from repro_torch.core.server import FedSAEServer, ServerConfig
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.models import fl_models as tfl
from repro_torch.tree import tree_items, tree_leaves
from torch_cases import one_torch_thread  # noqa: F401

DIM = 16
TOL = 2e-5
DS_KW = dict(n_clients=20, total=600, dim=DIM, max_size=24)
CFG_KW = dict(n_selected=5, lr=0.05, batch_size=4, rounds=2, h_cap=6.0,
              fixed_epochs=4.0, selection="random", sampling="iid")

MAKERS = {"mclr": (lambda m: m.make_mclr(DIM, 5)),
            "mlp": (lambda m: m.make_mlp(DIM, 5, hidden=8)),
            "lstm": (lambda m: m.make_lstm(40))}


def _batch(name):
    rng = np.random.default_rng(1)
    x = (rng.integers(0, 40, (4, 7)).astype(np.int32) if name == "lstm"
         else rng.normal(size=(4, DIM)).astype(np.float32))
    y = rng.integers(0, 2 if name == "lstm" else 5, 4).astype(np.int32)
    return {"x": x, "y": y, "mask": np.array([1, 1, 1, 0], np.float32)}


def _key_paths(tree):
    """The reference tree's leaf key paths in jax's flatten order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return tuple("/".join(str(k.key) for k in path) for path, _ in flat)


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_local_step_protocol_methods(name):
    """The reference test's protocol checks on the port's step, and its
    values against the reference step's on the same params."""
    jstep, step = MAKERS[name](jfl), MAKERS[name](tfl)
    assert step.name == jstep.name == name
    assert step.kind == jstep.kind and step.init is step.init_params
    rng = jax.random.PRNGKey(0)
    jp = jstep.init_params(rng)
    p = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    nb = _batch(name)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}

    value, grads = step.loss_and_grad(p, batch)
    assert torch.equal(value, step.loss(p, batch))
    assert set(grads) == set(p)
    stepped, step_loss = step.local_sgd_step(p, batch, 0.1)
    assert torch.equal(step_loss, value)
    for a, g, b in zip(tree_leaves(p), tree_leaves(grads),
                       tree_leaves(stepped)):
        np.testing.assert_allclose(b.numpy(), (a - 0.1 * g).numpy(),
                                   rtol=1e-6)

    jvalue, jgrads = jstep.loss_and_grad(jp, jbatch)
    jstepped, _ = jstep.local_sgd_step(jp, jbatch, 0.1)
    np.testing.assert_allclose(float(value), float(jvalue), rtol=1e-5,
                               atol=1e-5)
    for want, got in ((jgrads, grads), (jstepped, stepped)):
        got = params_to_numpy(got)
        for k, w in jax.tree.map(np.asarray, want).items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)

    # structure: the reference's flatten order and size, from a meta init
    assert step.param_treedef() == _key_paths(jp)
    assert step.param_treedef() == tuple(k for k, _ in tree_items(p))
    assert step.n_params() == jstep.n_params(rng) == sum(
        v.numel() for v in tree_leaves(p))
    assert step.n_params(torch.Generator().manual_seed(3)) == \
        step.n_params()


def test_param_treedef_of_an_lm_step_is_the_reference_order():
    """A full-width LM step's structure comes from a meta init: no
    storage, the reference's leaf order (stacked blocks included)."""
    from repro.configs import get_config as jget_config
    from repro.models.api import build_model as jbuild, from_model as jfrom
    from repro_torch.configs import get_config
    from repro_torch.models.api import from_model

    step = from_model(get_config("llama3.2-3b"))
    assert step.name == "model:llama3.2-3b"
    assert step.n_params() == 3_606_752_256
    jstep = jfrom(jget_config("llama3.2-3b", smoke=True))
    smoke = from_model(get_config("llama3.2-3b", smoke=True))
    jp = jbuild(jget_config("llama3.2-3b", smoke=True)).init(
        jax.random.PRNGKey(0))
    assert smoke.param_treedef() == _key_paths(jp)
    assert smoke.n_params() == jstep.n_params()
    assert len(step.param_treedef()) == len(smoke.param_treedef())


class _Duck:
    """A model that is not a ``LocalStep``: MCLR's functions."""

    def __init__(self, pkg, with_init=False, kind=None):
        fl = jfl if pkg == "ref" else tfl
        if pkg == "ref":
            self._init = lambda rng: fl.mclr_init(rng, DIM, 26)
        else:
            self._init = lambda gen: fl.mclr_init(gen, DIM, 26, gen.device)
        if with_init:
            self.init = self._init
        else:
            self.init_params = self._init
        self.loss = fl.mclr_loss
        self.accuracy = fl.mclr_accuracy
        self.kind = kind
        self.name = "duck"


def test_as_local_step_identity_and_coercion():
    step = tfl.make_mclr(DIM, 5)
    assert tfl.as_local_step(step) is step

    class Duck:
        def init_params(self, gen):
            return {"w": torch.zeros((2,), device=gen.device)}

        def loss(self, params, batch):
            return torch.sum(params["w"])

    coerced = tfl.as_local_step(Duck())
    assert isinstance(coerced, tfl.LocalStep)
    assert float(coerced.loss(coerced.init_params(torch.Generator()),
                              {})) == 0.0
    assert coerced.n_params() == 2 and coerced.param_treedef() == ("w",)
    wrapped = tfl.as_local_step(_Duck("port", with_init=True, kind="mclr"))
    assert (wrapped.kind, wrapped.name) == ("mclr", "duck")
    assert wrapped.accuracy is tfl.mclr_accuracy
    assert isinstance(tfl.FLModel(None, tfl.mclr_loss, None), tfl.LocalStep)
    for bad in (object(), 3, _Duck.__new__(_Duck)):
        with pytest.raises(TypeError, match="cannot interpret"):
            tfl.as_local_step(bad)
        with pytest.raises(TypeError, match="cannot interpret"):
            jfl.as_local_step(bad)


def test_resolve_local_step_coerces_every_non_string_spec():
    """C1: ``resolve_local_step`` hands every non-string spec to
    ``as_local_step``: a duck is wrapped, a non-model raises the
    reference's ``TypeError`` (it once raised ``KeyError: unknown
    arch``), through ``FedSAEServer(model=)`` too."""
    ds = tfemnist(**DS_KW)
    step = tfl.make_mlp(DIM, ds.n_classes)
    assert tfl.resolve_local_step(step, ds) is step
    duck = tfl.resolve_local_step(_Duck("port"), ds)
    assert isinstance(duck, tfl.LocalStep) and duck.name == "duck"
    assert tfl.resolve_local_step("mlp", ds).name == "mlp"
    assert tfl.resolve_local_step(None, ds).name == "mclr"
    with pytest.raises(KeyError):
        tfl.resolve_local_step("no_such_model", ds)
    for bad in (object(), 7):
        with pytest.raises(TypeError, match="cannot interpret"):
            tfl.resolve_local_step(bad, ds)
        with pytest.raises(TypeError, match="cannot interpret"):
            FedSAEServer(ds, model=bad, cfg=ServerConfig(device="cpu"))


@pytest.mark.parametrize("sampling", ["iid", "shuffle"])
def test_duck_round_is_its_local_step_round(sampling):
    """A duck trains through the padded and the packed round bitwise as
    the ``LocalStep`` built from the same functions."""
    ds = tfemnist(**DS_KW)
    duck = _Duck("port")
    twin = tfl.LocalStep(duck.init_params, duck.loss, duck.accuracy)
    params = duck.init_params(torch.Generator().manual_seed(0))
    ids = np.array([0, 3, 5, 9])
    n_iters = torch.tensor([4, 0, 7, 2], dtype=torch.int32)
    max_n = int(ds.sizes.max())
    x, y, mask, n = ds.stacked(ids, max_n)
    pk = ds.packed(max_n, device="cpu")
    eng = RoundEngine(0.05)
    outs = []
    for model in (duck, twin):
        padded = eng.make_padded_round(model, 4, 8, sampling=sampling)
        packed = eng.make_packed_round(model, 4, 8, max_n, sampling=sampling)
        outs.append((
            padded(params, x, y, mask, n, n_iters,
                   gen=torch.Generator().manual_seed(1)),
            packed(params, pk.x, pk.y, pk.offsets, pk.lengths,
                   torch.from_numpy(ids), n_iters,
                   gen=torch.Generator().manual_seed(1))))
    for a, b in zip(*outs):         # padded, then packed
        for k in params:
            assert torch.equal(a[0][k], b[0][k])
        assert torch.equal(a[1], b[1]) and bool(a[2]) == bool(b[2])


def test_duck_server_matches_the_reference_server():
    """A duck model through ``FedSAEServer`` against the reference's
    server with the reference's duck: the same init, the reference's
    minibatch draws injected; the same cohorts and budgets, params and
    losses within 2e-5."""
    from test_torch_server import _reference_draws
    jcfg = JConfig(**CFG_KW)
    jsrv = JServer(jfemnist(**DS_KW), model=_Duck("ref"), cfg=jcfg)
    init = jax.tree.map(np.asarray, jsrv.params)
    jhist = jsrv.run()
    srv = FedSAEServer(
        tfemnist(**DS_KW), model=_Duck("port"),
        cfg=ServerConfig(device="cpu", **CFG_KW), init_params=init,
        data_draws=_reference_draws(jcfg.seed, CFG_KW["rounds"],
                                    jsrv.max_iters, CFG_KW["batch_size"],
                                    jsrv.max_n, "iid"))
    hist = srv.run()
    assert srv.model.name == "duck" and srv.model.kind is None
    for a, b in zip(srv.cohorts, jsrv.cohorts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(srv.L, jsrv.L)
    got = params_to_numpy(srv.params)
    for k, w in jax.tree.map(np.asarray, jsrv.params).items():
        np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"],
                               rtol=TOL, atol=TOL)


def test_silo_takes_a_duck():
    """``SiloFedSAE`` coerces a non-``Model`` through ``as_local_step``."""
    from repro_torch.core.silo import SiloFedSAE
    fed = SiloFedSAE(_Duck("port"), 2, max_steps=2, device="cpu")
    assert isinstance(fed.step, tfl.LocalStep) and fed.step.name == "duck"
    with pytest.raises(TypeError):
        SiloFedSAE(object(), 2, device="cpu")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "falcon-mamba-7b"])
def test_loss_and_grad_of_an_lm_step_under_remat(arch):
    """``loss_and_grad`` of a ``from_model`` step whose config recomputes
    each layer group (``remat``: ``torch.utils.checkpoint``, which
    ``torch.func`` cannot differentiate) against the reference step's, on
    its params and a masked token batch, float32, 1e-4."""
    from repro.configs import get_config as jget_config
    from repro.models.api import from_model as jfrom
    from repro_torch.configs import get_config
    from repro_torch.models.api import from_model

    jcfg = jget_config(arch, smoke=True).replace(dtype="float32", remat=True)
    cfg = get_config(arch, smoke=True).replace(dtype="float32", remat=True)
    jstep, step = jfrom(jcfg), from_model(cfg)
    jp = jstep.init_params(jax.random.PRNGKey(0))
    p = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(0, 300, (4, 9)).astype(np.int32)
    mask = np.array([1, 1, 1, 0], np.float32)
    value, grads = step.loss_and_grad(
        p, {"x": torch.from_numpy(toks), "mask": torch.from_numpy(mask)})
    jvalue, jgrads = jstep.loss_and_grad(
        jp, {"x": jnp.asarray(toks), "mask": jnp.asarray(mask)})
    np.testing.assert_allclose(float(value), float(jvalue), rtol=1e-4,
                               atol=1e-4)
    want = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    got = dict(tree_items(grads))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
