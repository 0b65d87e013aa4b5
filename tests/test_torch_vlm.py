"""The VLM patch prefix (``internvl2-2b``'s smoke config) and training a
leaf the loss does not read, against the reference on the CPU.

Both packages start from the reference's params (``params_from_reference``)
and take the same numpy-made tokens and patches.  In float32 the port is
held to the reference's jitted functions at 1e-4: the prefix
(``embed_inputs``: the patches projected by ``modality_proj`` before the
tokens), ``train_loss`` and its gradients (the loss over the token
positions only), ``prefill`` (the cache keeps the patch positions) and
two decode steps, the serve driver's greedy loop (its decode index counts
the tokens only, a reference quirk the port keeps), the train CLI's batch
(the same draws from the same numpy seed), and ``fl_train --model
internvl2-2b``'s step in one host round of the LM federation.

A leaf the loss does not read (``modality_proj`` on a token-only batch)
trains with a zero gradient, as under ``jax.grad``: a silo round
(``_train_in_place``) and ``make_train_step`` on the reference CLI's
token-only batches match the reference's, with ``modality_proj``
unchanged under SGD and decayed under AdamW with weight decay, as the
reference's; and a toy model with an unread leaf trains through both
seams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.silo import SiloFedSAE as JSiloFedSAE
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.train import synth_batch as jsynth_batch
from repro.models import decoder as JD
from repro.models.api import VLM_FRONTEND_DIM as JVLM_DIM
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.engine import RoundEngine
from repro_torch.core.silo import SiloFedSAE
from repro_torch.launch import fl_train, serve, train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import decoder
from repro_torch.models.api import VLM_FRONTEND_DIM, build_model
from repro_torch.models.fl_models import LocalStep
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_items, tree_leaves, tree_unflatten
from test_torch_lm_federation import _assert_matches, _port, _reference
from torch_cases import one_torch_thread  # noqa: F401

ARCH = "internvl2-2b"
TOL = 1e-4
B, P, T = 2, 16, 32


def _np(x):
    return np.asarray(x.detach().to(torch.float32) if torch.is_tensor(x)
                      else jnp.asarray(x, jnp.float32))


def _close_tree(got, want, tol=TOL):
    got, want = dict(tree_items(got)), dict(tree_items(want))
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=tol,
                                   atol=tol, err_msg=k)


def _batch(cfg, seed=0, n_tokens=T, patches=True):
    ri = np.random.default_rng(seed)
    out = {"tokens": ri.integers(0, cfg.vocab_size, (B, n_tokens)
                                 ).astype(np.int32),
           "labels": ri.integers(0, cfg.vocab_size, (B, n_tokens)
                                 ).astype(np.int32)}
    if patches:
        out["patches"] = ri.normal(size=(B, P, VLM_FRONTEND_DIM)
                                   ).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """{dtype: (reference model, its params, port model, port params)}."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jm = jbuild_model(jget_config(ARCH, smoke=True).replace(dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(1))
        tm = build_model(get_config(ARCH, smoke=True).replace(dtype=dtype))
        out[dtype] = (jm, jp, tm,
                      params_from_reference(jax.tree.map(np.asarray, jp),
                                            "cpu"))
    return out


def test_vlm_params_and_prefix_match_reference(models):
    jm, jp, tm, tp = models["float32"]
    assert VLM_FRONTEND_DIM == JVLM_DIM == 1024
    own = tm.init(torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in tree_items(
        jax.tree.map(np.asarray, jp))}
    assert {k: tuple(v.shape) for k, v in tree_items(own)} == want
    assert want["modality_proj"] == (VLM_FRONTEND_DIM, tm.cfg.d_model)
    # modality_proj is a top-level leaf: the silo's layer views leave it
    assert tm.leaf_views(tp)["modality_proj"] is tp["modality_proj"]
    batch = _batch(tm.cfg)
    h = decoder.embed_inputs(tp, tm.cfg, _t(batch))
    jh = jax.jit(lambda p, b: JD.embed_inputs(p, jm.cfg, b))(jp, batch)
    assert tuple(h.shape) == (B, P + T, tm.cfg.d_model)
    np.testing.assert_allclose(_np(h), np.asarray(jh), rtol=TOL, atol=TOL)
    # a batch without patches embeds its tokens alone
    del batch["patches"]
    np.testing.assert_array_equal(
        _np(decoder.embed_inputs(tp, tm.cfg, _t(batch))),
        np.asarray(JD.embed_inputs(jp, jm.cfg, batch)))


def test_vlm_train_loss_and_grads_match_reference(models):
    jm, jp, tm, tp = models["float32"]
    batch = _batch(tm.cfg, seed=1)
    batch["mask"] = np.random.default_rng(2).random((B, T)) < 0.8
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.train_loss,
                                                has_aux=True))(jp, batch)
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(tp)]
    loss, _ = tm.train_loss(tree_unflatten(tp, leaves), _t(batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    _close_tree(tree_unflatten(tp, grads), jax.tree.map(np.asarray, jg))
    assert float(dict(tree_items(tree_unflatten(tp, grads)))[
        "modality_proj"].abs().max()) > 0


def test_vlm_prefill_decode_and_generate_match_reference(models):
    """Prefill over P + T positions (the cache keeps them all), then the
    serve driver's greedy loop with cur = T + i, the reference's: the same
    tokens, the caches and the last logits within 1e-4."""
    jm, jp, tm, tp = models["float32"]
    S, gen = 40, 3
    batch = serve.prompt_batch(tm.cfg, B, S, "cpu")
    Pn = min(tm.cfg.n_patches, S // 4)
    ri = np.random.default_rng(0)
    tokens = ri.integers(0, tm.cfg.vocab_size, (B, S))[:, :S - Pn]
    patches = ri.normal(size=(B, Pn, VLM_FRONTEND_DIM))
    np.testing.assert_array_equal(batch["tokens"].numpy(), tokens)
    np.testing.assert_array_equal(batch["patches"].numpy(),
                                  patches.astype(np.float32))
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "patches": jnp.asarray(patches, jnp.float32)}
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    logits, cache = prefill(jp, jb)
    tlogits, tcache = tm.prefill(tp, batch)
    assert tcache["pos0"]["k"].shape[2] == S
    np.testing.assert_allclose(_np(tlogits), np.asarray(logits), rtol=TOL,
                               atol=TOL)
    _close_tree(tcache, jax.tree.map(np.asarray, cache))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen):
        logits, cache = decode(jp, cache, tok, jnp.int32(S - Pn + i))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    got, glogits, _ = serve.generate(tm, tp, batch, gen)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, 1)))
    np.testing.assert_allclose(glogits.numpy(), np.asarray(logits),
                               rtol=TOL, atol=TOL)


def test_vlm_train_cli_batch_matches_reference(models):
    jm, jp, tm, tp = models["float32"]
    rng = jax.random.PRNGKey(5)
    jb = jsynth_batch(jm.cfg, rng, B, 64)
    seed = int(jax.random.randint(rng, (), 0, 2 ** 31 - 1))
    tb = train.synth_batch_from(tm.cfg, np.random.default_rng(seed), B, 64)
    assert set(tb) == {"tokens", "labels", "patches"}
    assert tuple(tb["patches"].shape) == (B, 16, VLM_FRONTEND_DIM)
    assert tuple(tb["tokens"].shape) == (B, 48)
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    np.testing.assert_allclose(float(tm.train_loss(tp, tb)[0]),
                               float(jax.jit(jm.train_loss)(jp, jb)[0]),
                               rtol=TOL, atol=TOL)


def test_vlm_bfloat16_is_finite(models):
    _, _, tm, tp = models["bfloat16"]
    loss, _ = tm.train_loss(tp, _t(_batch(tm.cfg, seed=3)))
    assert torch.isfinite(loss)
    batch = serve.prompt_batch(tm.cfg, B, 40, "cpu")
    got, logits, _ = serve.generate(tm, tp, batch, 2)
    assert tuple(got.shape) == (B, 3) and torch.isfinite(logits).all()


def test_fl_train_model_internvl2_host_round_matches_reference():
    """``fl_train --model internvl2-2b``'s step (``from_model`` of the
    smoke config, token-only batches) in one host round of the LM
    federation, float32, against the reference's server: cohorts, budgets
    and L/H bitwise, params and losses within 1e-4; the CLI resolves the
    id to that step."""
    ref = _reference(ARCH, rounds=1)
    tsrv = _port(ref, ARCH)
    tsrv.run()
    _assert_matches(tsrv, ref, TOL)
    args = fl_train.parse_args(["--dataset", "sent140", "--model", ARCH,
                                "--device", "cpu"])
    assert fl_train.build_server(args).model.name == f"model:{ARCH}"


# ---------------------------------------------------------------------------
# a leaf the loss does not read
# ---------------------------------------------------------------------------


def _toy_step():
    """A quadratic model with a leaf ``unused`` its loss never reads."""
    def init(generator):
        return {"w": torch.randn((4, 2), generator=generator),
                "unused": torch.ones((3,))}
    return LocalStep(init_params=init, name="toy",
                     loss=lambda p, b: torch.mean((b["x"] @ p["w"]
                                                   - b["y"]) ** 2))


def test_unread_leaf_trains_with_a_zero_gradient_in_both_seams():
    step = _toy_step()
    params = step.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = {"x": torch.from_numpy(rng.normal(size=(2, 3, 8, 4))
                                     .astype(np.float32)),
               "y": torch.from_numpy(rng.normal(size=(2, 3, 8, 2))
                                     .astype(np.float32))}
    round_fn = RoundEngine(lr=0.1).make_stream_round(step, 3)
    new, losses = round_fn(params, batches, np.array([3, 2]),
                           torch.tensor([1.0, 1.0]))
    assert torch.equal(new["unused"], params["unused"])
    assert not torch.equal(new["w"], params["w"])
    opt = sgd(0.1)
    model = type("M", (), {"train_loss": staticmethod(
        lambda p, b: (step.loss(p, b), {}))})()
    p1, _, loss = make_train_step(model, opt)(
        params, opt.init(params), {"x": batches["x"][0, 0],
                                   "y": batches["y"][0, 0]})
    assert torch.equal(p1["unused"], params["unused"])
    assert torch.isfinite(loss)


def test_token_only_silo_round_leaves_modality_proj_and_matches_reference():
    """``fl_train --silo-arch internvl2-2b``'s batches (tokens only): the
    silo round trains every other leaf as the reference's does and leaves
    ``modality_proj`` as it was."""
    jcfg = jget_config(ARCH, smoke=True).replace(dtype="float32")
    tcfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    K, max_steps = 2, 3
    jfed = JSiloFedSAE(jbuild_model(jcfg), K, lr=5e-3, max_steps=max_steps)
    init = jax.tree.map(np.asarray, jfed.params)
    tfed = SiloFedSAE(build_model(tcfg), K, lr=5e-3, max_steps=max_steps,
                      init_params=init, device="cpu")
    ri = np.random.default_rng(0)
    sizes = np.asarray(ri.integers(100, 1000, K))
    toks = fl_train.silo_tokens(ri, tcfg, K, max_steps, S=24)
    jstats = jfed.run_round({"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(toks)}, sizes)
    tstats = tfed.run_round({"tokens": toks, "labels": toks}, sizes)
    assert int(tfed.last_n_steps.sum()) > 0
    np.testing.assert_array_equal(tfed.L, jfed.L)
    np.testing.assert_allclose(tstats["loss"][-1], jstats["loss"][-1],
                               rtol=TOL, atol=TOL)
    _close_tree(tfed.params, jax.tree.map(np.asarray, jfed.params))
    # FedAvg of the silos' equal rows rounds within an ulp of them
    np.testing.assert_allclose(tfed.params["modality_proj"].numpy(),
                               init["modality_proj"], rtol=1e-6, atol=0)
    # a silo's local steps leave it bitwise
    row = tree_unflatten(tfed.params, [t.clone() for t in
                                       tree_leaves(tfed.params)])
    one = {"tokens": torch.from_numpy(toks[0]),
           "labels": torch.from_numpy(toks[0])}
    tfed.round_fn.train_silo(row, tfed.params, one, max_steps)
    assert torch.equal(row["modality_proj"], tfed.params["modality_proj"])
    assert not torch.equal(row["embeddings"]["tok"],
                           tfed.params["embeddings"]["tok"])


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_token_only_train_step_matches_reference(models, opt_name):
    """``make_train_step`` on a token-only batch: the step matches the
    reference's; ``modality_proj``'s gradient is zero, so SGD leaves it
    and AdamW with weight decay only decays it, in both packages."""
    jm, jp, tm, tp = models["float32"]
    batch = _batch(tm.cfg, seed=4, patches=False)
    jopt, topt = ((jsgd(0.1), sgd(0.1)) if opt_name == "sgd" else
                  (jadamw(1e-2, weight_decay=0.1),
                   adamw(1e-2, weight_decay=0.1)))
    jnew, _, jloss = jax.jit(jmake_train_step(jm, jopt))(
        jp, jopt.init(jp), jax.tree.map(jnp.asarray, batch))
    tnew, _, loss = make_train_step(tm, topt)(tp, topt.init(tp), _t(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL,
                               atol=TOL)
    jnew = jax.tree.map(np.asarray, jnew)
    before = tp["modality_proj"]
    if opt_name == "sgd":
        _close_tree(tnew, jnew, 1e-5)
        assert torch.equal(tnew["modality_proj"], before)
    else:
        # AdamW's step is about lr * sign(g) wherever |g| nears its eps,
        # so only the unread leaf is compared: decayed alone, as the
        # reference's
        np.testing.assert_allclose(tnew["modality_proj"].numpy(),
                                   jnew["modality_proj"], rtol=1e-6, atol=0)
        torch.testing.assert_close(tnew["modality_proj"],
                                   before * (1 - 1e-2 * 0.1))
