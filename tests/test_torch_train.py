"""The port's LM training path against the reference, on the CPU.

Both packages start from the reference's params (``params_from_reference``)
and the same numpy-made batches.  Tolerances:

- float32: losses and the gradient of every params leaf within 1e-4 (the
  LM blocks' float32 bound, tests/test_torch_lm_kernels.py: another
  summation order than XLA);
- bfloat16, held op by op (``jax.disable_jit``), as the serving path is
  (tests/test_torch_serve.py): the loss within 2e-2, the reference's bf16
  model bound, and each gradient leaf within 2e-2 of its own largest
  magnitude.  ``decoder.train_loss`` runs its loss chunks through the
  fused cross-entropy (a float32 product), which the reference's
  ``train_loss`` never selects (``use_fused=False``, a bf16 product), so
  the bf16 reference here is its forward plus
  ``chunked_lm_loss(use_fused=True)``;
- optimizers: 3 updates elementwise within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import decoder as JD
from repro.models import layers as JL
from repro.models.api import build_model as jbuild_model
from repro.models.api import from_model as jfrom_model
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model, from_model
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_leaves, tree_map
from torch_cases import one_torch_thread  # noqa: F401

ARCHS = ["llama3.2-3b", "falcon-mamba-7b"]


def _models(arch, dtype="float32"):
    jcfg = jget_config(arch, smoke=True).replace(dtype=dtype)
    tcfg = get_config(arch, smoke=True).replace(dtype=dtype)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(cfg, B=2, S=48, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = rng.random((B, S)) > 0.25 if masked else np.ones((B, S), bool)
    return {"tokens": tokens, "labels": labels, "mask": mask}


def _torch_grads(fn, params):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    value = fn(params)
    grads = torch.autograd.grad(value, leaves)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(grads)
    return value.detach(), tree_map(lambda _: next(it), params)


def _close_tree(got, want, atol, rtol=None, scaled=False):
    want = jax.tree.map(lambda x: np.asarray(x, np.float32), want)
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(
                  tree_map(lambda t: t.float().numpy(), got))[0]}
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        tol = atol * max(float(np.abs(w).max()), 1e-30) if scaled else atol
        np.testing.assert_allclose(flat_g[k], w, atol=tol,
                                   rtol=rtol if rtol is not None else atol,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference_f32(arch):
    jm, jp, tm, tp = _models(arch)
    batch = _batch(tm.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, jax.tree.map(jnp.asarray, batch))[0]))(jp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _torch_grads(lambda p: tm.train_loss(p, tbatch)[0], tp)
    _, metrics = tm.train_loss(tp, tbatch)
    assert float(metrics["aux_loss"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4,
                               rtol=1e-4)
    _close_tree(grads, jgrads, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference_bf16_op_by_op(arch):
    jm, jp, tm, tp = _models(arch, "bfloat16")
    jcfg = jm.cfg
    batch = _batch(tm.cfg, S=32, seed=1)

    def jloss_fn(p):
        jb = jax.tree.map(jnp.asarray, batch)
        B, S = jb["tokens"].shape
        h = JD.embed_inputs(p, jcfg, jb)
        pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
        h, _, _ = JD.forward(p, jcfg, h, pos, "train")
        return JL.chunked_lm_loss(p["embeddings"], jcfg, h, jb["labels"],
                                  jb["mask"], use_fused=True)

    with jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(jloss_fn)(jp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _torch_grads(lambda p: tm.train_loss(p, tbatch)[0], tp)
    np.testing.assert_allclose(float(loss), float(jloss), atol=2e-2,
                               rtol=2e-2)
    _close_tree(grads, jgrads, 2e-2, rtol=0.0, scaled=True)


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("S,chunk", [(64, 16), (60, 16), (64, 1024)])
def test_chunked_lm_loss_matches_reference(S, chunk, use_fused):
    """Four chunks, a length the chunk does not divide (one chunk of S),
    and S < chunk; masked, in float32."""
    jcfg = jget_config("llama3.2-3b", smoke=True).replace(dtype="float32")
    tcfg = get_config("llama3.2-3b", smoke=True).replace(dtype="float32")
    je, _ = JL.init_embeddings(jax.random.PRNGKey(2), jcfg)
    te = params_from_reference(jax.tree.map(np.asarray, je), device="cpu")
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    mask = rng.random((2, S)) > 0.3
    want = JL.chunked_lm_loss(je, jcfg, jnp.asarray(h), jnp.asarray(labels),
                              jnp.asarray(mask), chunk=chunk)
    got = TL.chunked_lm_loss(te, tcfg, torch.from_numpy(h),
                             torch.from_numpy(labels),
                             torch.from_numpy(mask), chunk=chunk,
                             use_fused=use_fused)
    np.testing.assert_allclose(float(got), float(want), atol=1e-5,
                               rtol=1e-5)
    nomask = TL.chunked_lm_loss(te, tcfg, torch.from_numpy(h),
                                torch.from_numpy(labels), chunk=chunk,
                                use_fused=use_fused)
    np.testing.assert_allclose(
        float(nomask), float(JL.chunked_lm_loss(
            je, jcfg, jnp.asarray(h), jnp.asarray(labels), chunk=chunk)),
        atol=1e-5, rtol=1e-5)


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, 33)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) > 0.5
    for m in (None, mask, np.zeros((3, 7), bool)):
        got = TL.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), atol=1e-6,
                                   rtol=1e-6)


def test_from_model_loss_and_accuracy_match_reference():
    jm, jp, tm, tp = _models("llama3.2-3b")
    rng = np.random.default_rng(5)
    x = rng.integers(0, tm.cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"x": x, "y": np.zeros(4, np.int32),
             "mask": np.array([1, 1, 0, 1], np.float32)}
    jstep, tstep = jfrom_model(jm), from_model(tm)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(tstep.loss(tp, tb)),
                               float(jstep.loss(jp, jb)), atol=1e-4,
                               rtol=1e-4)
    assert float(tstep.accuracy(tp, tb)) == float(jstep.accuracy(jp, jb))
    # lm_seq_len cuts the rows; without a mask every row counts
    del tb["mask"], jb["mask"]
    np.testing.assert_allclose(
        float(from_model(tm, lm_seq_len=9).loss(tp, tb)),
        float(jfrom_model(jm, lm_seq_len=9).loss(jp, jb)), atol=1e-4,
        rtol=1e-4)
    assert tstep.kind == "lm" and tstep.leaf_views is tm.leaf_views
    with pytest.raises(ValueError, match="encoder-decoder"):
        from_model(tm.cfg.replace(is_encoder_decoder=True))


def test_train_loss_remat_gives_the_same_gradients():
    _, _, tm, tp = _models("llama3.2-3b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg).items()}
    remat = build_model(tm.cfg.replace(remat=True))
    a, ga = _torch_grads(lambda p: tm.train_loss(p, batch)[0], tp)
    b, gb = _torch_grads(lambda p: remat.train_loss(p, batch)[0], tp)
    assert float(a) == float(b)
    for x, y in zip(tree_leaves(ga), tree_leaves(gb)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_carries_the_lm_tree_both_ways(arch):
    jm, jp, tm, tp = _models(arch)
    want = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_structure(params_to_numpy(fresh)) == \
        jax.tree_util.tree_structure(want)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "blocks": {"w": rng.normal(size=(2, 4)).astype(np.float32),
                       "b": rng.normal(size=(4,)).astype(np.float32)}}


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.01, grad_clip=0.5)),
    ("adamw", dict(lr=1e-2)),
    ("adamw", dict(lr=1e-2, weight_decay=0.1, warmup_steps=2,
                   grad_clip=0.3)),
])
def test_optimizers_match_reference(name, kw):
    jopt = (jsgd if name == "sgd" else jadamw)(**kw)
    topt = (sgd if name == "sgd" else adamw)(**kw)
    p0 = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = params_from_reference(p0, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda x: x * (3.0 - i), _opt_tree(10 + i))
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(params_from_reference(g, device="cpu"), ts, tp)
        _close_tree(tp, jp, 1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_the_smoke_config_on_the_cpu(arch, capsys,
                                                    tmp_path):
    losses = ttrain.main(["--arch", arch, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "32", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert f"arch={arch} smoke=True" in out and "step    2" in out
    # --checkpoint (once refused, ROADMAP A11) writes the trained params
    path = str(tmp_path / "params.pt")
    ttrain.main(["--arch", arch, "--smoke", "--steps", "1", "--batch", "2",
                 "--seq", "32", "--device", "cpu", "--checkpoint", path])
    assert f"checkpoint -> {path}" in capsys.readouterr().out
    flat, step, _ = load_checkpoint(path)
    assert step == 1 and flat
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all()
               for t in flat.values())


def test_train_step_matches_reference_and_serving_steps_run():
    """One SGD train step through the per-layer leaves (gradients
    restacked) against the reference's step; then the prefill and decode
    step builders."""
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro_torch.launch import steps as tsteps
    jm, jp, tm, tp = _models("llama3.2-3b")
    batch = _batch(tm.cfg, masked=False)
    jopt, topt = jsgd(0.1), tsteps.make_optimizer("sgd", 0.1)
    jnew, _, jloss = jax.jit(jmake_train_step(jm, jopt))(
        jp, jopt.init(jp), jax.tree.map(jnp.asarray, batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tnew, state, loss = tsteps.make_train_step(tm, topt)(
        tp, topt.init(tp), tbatch)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4,
                               rtol=1e-4)
    _close_tree(tnew, jnew, 1e-5)
    assert int(state["step"]) == 1
    logits, cache = tsteps.make_prefill_step(tm)(tp, tbatch)
    nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
    logits2, _ = tsteps.make_decode_step(tm)(tp, cache, nxt, 48)
    assert logits2.shape == (2, tm.cfg.vocab_size)
    assert torch.isfinite(logits2).all()
    with pytest.raises(ValueError):
        tsteps.make_optimizer("lion")
