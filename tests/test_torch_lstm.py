"""The port's Sent140 LSTM step against the reference's, on the same
numpy-made inputs.

Tolerances: logits, loss and every gradient leaf within 1e-5 (float32, a
25-step recurrence summed in another order); three host rounds on a small
Sent140 federation within 2e-5 (the reference's local-SGD bound, as for
MCLR and the MLP), with cohorts, L/H/theta and workloads bitwise and test
accuracy within 2/test_n.  The compressed round is held set-wise, as
``test_torch_compression.py`` holds the MLP's: kept sets agree on at least
99.9% of coordinates, values within 2e-5 where both kept a coordinate,
and the error-feedback identity exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.core import compression as jcomp
from repro.core.engine import RoundEngine as JEngine
from repro.core.server import FedSAEServer as JServer
from repro.core.server import ServerConfig as JConfig
from repro.data.federated import FederatedDataset as JDataset
from repro.data.federated import make_sent140_like as jsent140
from repro.models import fl_models as jfl
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.core import compression as tcomp
from repro_torch.core.engine import RoundEngine as TEngine
from repro_torch.core.server import FedSAEServer as TServer
from repro_torch.core.server import ServerConfig as TConfig
from repro_torch.data.federated import FederatedDataset as TDataset
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.data.federated import make_sent140_like as tsent140
from repro_torch.launch import fl_train
from repro_torch.models import fl_models as tfl
from test_torch_server import _reference_draws
from torch_cases import one_torch_thread  # noqa: F401


LOGIT_TOL = 1e-5
TOL = 2e-5
DS_KW = dict(n_clients=16, total=320, vocab=260, max_size=30)
CFG_KW = dict(n_selected=5, lr=0.3, batch_size=4, rounds=3, h_cap=6.0,
              fixed_epochs=4.0, selection="random")


def _batch(seed, B, S, vocab, masked=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, S)).astype(np.int32)
    y = rng.integers(0, 2, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    mask[B - masked:] = 0.0
    return {"x": x, "y": y, "mask": mask}


def _reference_params(vocab, seed=7):
    return jax.tree.map(np.asarray,
                        jfl.lstm_init(jax.random.PRNGKey(seed), vocab))


@pytest.mark.parametrize("B,S,vocab", [(6, 25, 40), (3, 7, 300)])
def test_logits_loss_and_grads_match_reference(B, S, vocab):
    params = _reference_params(vocab)
    batch = _batch(B + S, B, S, vocab)
    jb = jax.tree.map(jnp.asarray, batch)
    tp = params_from_reference(params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        tfl.lstm_logits(tp, tb["x"]).numpy(),
        np.asarray(jfl.lstm_logits(params, jb["x"])),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(tfl.lstm_loss(tp, tb)),
                               float(jfl.lstm_loss(params, jb)),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert float(tfl.lstm_accuracy(tp, tb)) == float(
        jfl.lstm_accuracy(params, jb))
    tg = grad(tfl.lstm_loss)(tp, tb)
    jg = jax.grad(jfl.lstm_loss)(params, jb)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_init_layout_and_flatten_order():
    """The reference's insertion order and shapes; P = 56,962 at the
    paper's vocabulary of 1,000; the [K, P] flatten reads the leaves in
    sorted-key order (b, b_out, emb, w_out, wh, wx)."""
    gen = torch.Generator().manual_seed(0)
    tp = tfl.make_lstm(1000).init_params(gen)
    jp = jfl.make_lstm(1000).init(jax.random.PRNGKey(0))
    assert list(tp) == list(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        assert tp[k].dtype == torch.float32
    assert tcomp.n_params_of(tp) == jfl.make_lstm(1000).n_params() == 56962
    assert not tp["b"].any() and not tp["b_out"].any()
    assert abs(float(tp["emb"].std()) - 0.1) < 0.01
    flat = tcomp.flatten_global(tp)
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([tp[k].reshape(-1).numpy() for k in
                                      ("b", "b_out", "emb", "w_out", "wh",
                                       "wx")]))
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jcomp.flatten_global(
            params_to_numpy(tp))))


def test_resolve_local_step_defaults_and_errors():
    tds, jds = tsent140(**DS_KW), jsent140(**DS_KW)
    step = tfl.resolve_local_step(None, tds)
    assert step.kind is None and step.loss is tfl.lstm_loss
    assert tfl.resolve_local_step("lstm", tds).loss is tfl.lstm_loss
    assert tfl._dataset_dims(tds) == jfl._dataset_dims(jds)
    assert tfl.resolve_local_step("mclr", tfemnist(
        n_clients=6, total=100, dim=8, max_size=30)).kind == "mclr"
    femnist = tfemnist(n_clients=6, total=100, dim=8, max_size=30)
    with pytest.raises(ValueError, match="needs a text"):
        tfl.resolve_local_step("lstm", femnist)
    # arch ids on a text dataset resolve to the causal-LM step
    for spec in ("llama3.2-3b", "falcon-mamba-7b"):
        assert tfl.resolve_local_step(spec, tds).kind == "lm"


def test_vocab_is_read_from_the_clients_shards_only():
    """A test token past every client's: the vocabulary (and so P) is the
    clients' largest token + 1, as the reference sizes it."""
    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 50, (5, 25)).astype(np.int32) for _ in range(3)]
    ys = [np.zeros(5, np.int32) for _ in range(3)]
    test_x = np.full((4, 25), 90, np.int32)
    args = ("sent140", xs, ys, test_x, np.zeros(4, np.int32), 2)
    t = tfl._dataset_dims(TDataset(*args, task="text"))
    assert t == jfl._dataset_dims(JDataset(*args, task="text"))
    assert t[2] == int(max(x.max() for x in xs)) + 1


@pytest.mark.parametrize("sampling", ["shuffle", "iid"])
def test_three_host_rounds_match_reference(sampling):
    jsrv = JServer(jsent140(**DS_KW),
                   cfg=JConfig(algo="ira", sampling=sampling, **CFG_KW))
    init = jax.tree.map(np.asarray, jsrv.params)
    jhist = jsrv.run()
    tds = tsent140(**DS_KW)
    tsrv = TServer(tds, cfg=TConfig(algo="ira", sampling=sampling,
                                    device="cpu", **CFG_KW),
                   init_params=init,
                   data_draws=_reference_draws(
                       0, 3, jsrv.max_iters, CFG_KW["batch_size"],
                       int(tds.sizes.max()), sampling))
    assert tsrv.max_iters == jsrv.max_iters
    assert tsrv.model.kind is None
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
    for k in ("dropout", "assigned", "uploaded", "true_workload"):
        np.testing.assert_array_equal(thist[k], jhist[k])
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(thist[k], jhist[k], rtol=TOL, atol=TOL)
    assert np.max(np.abs(np.subtract(thist["acc"], jhist["acc"]))) \
        <= 2.0 / len(tds.test_y)


B, MAX_ITERS, LR, FRAC = 4, 6, 0.3, 0.1


def test_compressed_round_matches_reference_setwise(monkeypatch):
    """One iid round with topk_q8 on the LSTM; the reference's kept set is
    read out of its jitted round through a debug callback."""
    jds, tds = jsent140(**DS_KW), tsent140(**DS_KW)
    max_n = int(jds.sizes.max())
    ids = np.array([0, 3, 5, 8, 12])
    n_iters = np.array([0, 1, 6, 4, 2], np.int32)
    vocab = jfl._dataset_dims(jds)[2]
    jparams = jfl.lstm_init(jax.random.PRNGKey(7), vocab)
    P = sum(int(np.size(v)) for v in jax.tree.leaves(jparams))
    residual = np.random.default_rng(4).normal(
        scale=1e-3, size=(jds.n_clients, P)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    seen = {"j": {}, "t": {}}
    j_inner, t_inner = jcomp.compress_rows, tcomp.compress_rows

    def j_capture(ef, k, backend):
        q, scale = j_inner(ef, k, backend)
        jax.debug.callback(lambda v: seen["j"].update(q=np.asarray(v)), q)
        return q, scale

    def t_capture(ef, k):
        q, scale = t_inner(ef, k)
        seen["t"].update(ef=ef.numpy().copy(), q=q.numpy().copy(),
                         scale=scale.numpy().copy())
        return q, scale

    monkeypatch.setattr(jcomp, "compress_rows", j_capture)
    monkeypatch.setattr(tcomp, "compress_rows", t_capture)
    jfn = JEngine(lr=LR, donate=False, compress="topk_q8", topk_frac=FRAC
                  ).make_packed_round(jfl.make_lstm(vocab), B, MAX_ITERS,
                                      max_n, sampling="iid")
    pk = jds.packed(max_n)
    jp, jl, _, jres = jfn(jparams, pk.x, pk.y, pk.offsets, pk.lengths,
                          jnp.asarray(ids, jnp.int32), jnp.asarray(n_iters),
                          rng, jnp.asarray(residual))
    jax.effects_barrier()
    n = np.minimum(jds.sizes[ids], max_n)
    keys = jax.random.split(rng, len(ids))
    draws = np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
        k, (MAX_ITERS, B), 0, jnp.maximum(nk, 1)))(keys, jnp.asarray(n)))
    tfn = TEngine(lr=LR, compress="topk_q8", topk_frac=FRAC
                  ).make_packed_round(tfl.make_lstm(vocab), B, MAX_ITERS,
                                      max_n, sampling="iid")
    tpk = tds.packed(max_n, device="cpu")
    tp, tl, _, tres = tfn(
        params_from_reference(jax.tree.map(np.asarray, jparams), "cpu"),
        tpk.x, tpk.y, tpk.offsets, tpk.lengths, torch.from_numpy(ids),
        torch.from_numpy(n_iters), draws=draws,
        residual=torch.from_numpy(residual.copy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    tres, jres = tres.numpy(), np.asarray(jres)
    up = n_iters > 0
    tkept, jkept = seen["t"]["q"] != 0, seen["j"]["q"] != 0
    assert (tkept == jkept)[up].mean() >= 0.999
    both = tkept & jkept
    np.testing.assert_allclose(tres[ids][both], jres[ids][both], rtol=TOL,
                               atol=TOL)
    sent = seen["t"]["q"].astype(np.float32) * seen["t"]["scale"][:, None]
    np.testing.assert_array_equal((sent + tres[ids])[up],
                                  seen["t"]["ef"][up])
    keep = np.ones(jds.n_clients, bool)
    keep[ids[up]] = False
    np.testing.assert_array_equal(tres[keep], residual[keep])
    same = (tkept == jkept)[up].all(0)
    flat_t = tcomp.flatten_global(tp).numpy()
    flat_j = np.asarray(jcomp.flatten_global(jp))
    np.testing.assert_allclose(flat_t[same], flat_j[same], rtol=TOL,
                               atol=TOL)


def test_cli_sent140_on_cpu(capsys):
    hist = fl_train.main(["--dataset", "sent140", "--device", "cpu",
                          "--rounds", "2", "--quiet"])
    assert len(hist["acc"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert "final: acc=" in capsys.readouterr().out
