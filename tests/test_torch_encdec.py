"""The port's encoder-decoder (``models/encdec.py``, whisper-tiny's smoke
config) against the reference's ``repro/models/encdec.py`` on the CPU.

Both start from the reference's params (``params_from_reference``) and
take the same numpy-made frames and tokens.  In float32 the port is held
to the reference's jitted functions at 1e-4 (another summation order):
``encode``, ``decoder_forward`` in train and prefill mode, ``train_loss``
and its gradients, ``prefill``'s logits and cache (a 12-token prompt
padded to ``max_decoder_len`` = 32 slots, and a 40-token one cut to
them), two ``decode_step``s after it, decode from an empty cache, the
serve driver's greedy loop (the same tokens), the train CLI's batch (the
same draws from the same numpy seed, then the same loss), and one
``SiloFedSAE`` round with frames in its batches (L, H and the budgets
bitwise).  In bfloat16 (the config's own) the loss, its gradients and a
prefill plus decode are finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.silo import SiloFedSAE as JSiloFedSAE
from repro.launch.train import synth_batch as jsynth_batch
from repro.models import encdec as jencdec
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.silo import SiloFedSAE
from repro_torch.launch import fl_train, serve, train
from repro_torch.models import encdec
from repro_torch.models.api import build_model, from_model
from repro_torch.tree import tree_items, tree_leaves, tree_unflatten
from torch_cases import one_torch_thread  # noqa: F401

ARCH = "whisper-tiny"
TOL = 1e-4
B, F, T = 2, 48, 12


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


def _batch(cfg, seed=0, n_frames=F, n_tokens=T):
    ri = np.random.default_rng(seed)
    return {"frames": ri.normal(size=(B, n_frames, encdec.FRONTEND_DIM)
                                ).astype(np.float32),
            "tokens": ri.integers(0, cfg.vocab_size, (B, n_tokens)
                                  ).astype(np.int32),
            "labels": ri.integers(0, cfg.vocab_size, (B, n_tokens)
                                  ).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """{dtype: (reference model, its params, port model, port params)}."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = jget_config(ARCH, smoke=True).replace(dtype=dtype)
        jm = jbuild_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(1))
        tm = build_model(get_config(ARCH, smoke=True).replace(dtype=dtype))
        out[dtype] = (jm, jp, tm,
                      params_from_reference(jax.tree.map(np.asarray, jp),
                                            "cpu"))
    return out


def test_config_and_params_are_the_references(models):
    for smoke in (False, True):
        j, t = jget_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}
    jm, jp, tm, tp = models["float32"]
    own = tm.init(torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in tree_items(
        jax.tree.map(np.asarray, jp))}
    assert {k: tuple(v.shape) for k, v in tree_items(own)} == want
    assert {k: tuple(v.shape) for k, v in tree_items(tp)} == want
    assert encdec.FRONTEND_DIM == jencdec.FRONTEND_DIM
    # the silo round's per-layer leaves: both stacks split, nothing else
    views = tm.leaf_views(tp)
    assert len(views["enc_blocks"]["attn"]["wq"]) == tm.cfg.n_encoder_layers
    assert len(views["dec_blocks"]["cross"]["wk"]) == tm.cfg.n_layers
    assert views["enc_proj"] is tp["enc_proj"]


def test_encode_and_decoder_forward_match_reference(models):
    jm, jp, tm, tp = models["float32"]
    cfg, jcfg = tm.cfg, jm.cfg
    batch = _batch(cfg)

    @jax.jit
    def ref(p, b):
        enc = jencdec.encode(p, jcfg, b["frames"])
        h_train, _ = jencdec.decoder_forward(p, jcfg, b["tokens"], enc,
                                             "train")
        h_pre, caches = jencdec.decoder_forward(p, jcfg, b["tokens"], enc,
                                                "prefill")
        return enc, h_train, h_pre, caches

    jenc, jh_train, jh_pre, jcaches = ref(jp, batch)
    tb = _t(batch)
    enc = encdec.encode(tp, cfg, tb["frames"])
    np.testing.assert_allclose(_np(enc), np.asarray(jenc), rtol=TOL,
                               atol=TOL)
    h_train, none = encdec.decoder_forward(tp, cfg, tb["tokens"], enc,
                                           "train")
    assert none is None
    np.testing.assert_allclose(_np(h_train), np.asarray(jh_train),
                               rtol=TOL, atol=TOL)
    h_pre, caches = encdec.decoder_forward(tp, cfg, tb["tokens"], enc,
                                           "prefill")
    np.testing.assert_allclose(_np(h_pre), np.asarray(jh_pre), rtol=TOL,
                               atol=TOL)
    _close_tree(caches, jax.tree.map(np.asarray, jcaches))
    with pytest.raises(ValueError, match="unknown mode"):
        encdec.decoder_forward(tp, cfg, tb["tokens"], enc, "eval")


def test_train_loss_and_grads_match_reference(models):
    jm, jp, tm, tp = models["float32"]
    batch = _batch(tm.cfg, seed=1)
    batch["mask"] = np.random.default_rng(2).random((B, T)) < 0.8
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.train_loss,
                                                has_aux=True))(jp, batch)
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(tp)]
    loss, metrics = tm.train_loss(tree_unflatten(tp, leaves), _t(batch))
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL,
                               atol=TOL)
    assert float(metrics["lm_loss"].detach()) == float(loss)
    _close_tree(tree_unflatten(tp, grads), jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("n_tokens", [T, 40])
def test_prefill_and_two_decode_steps_match_reference(models, n_tokens):
    """A 12-token prompt (its self K/V padded to 32 slots) and a 40-token
    one (cut to them); then two decode steps, the first at slot 12 (or
    31, the last slot, for the cut prompt)."""
    jm, jp, tm, tp = models["float32"]
    batch = _batch(tm.cfg, seed=3, n_tokens=n_tokens)
    del batch["labels"]
    steps = [np.array([[3], [250]], np.int32), np.array([[7], [0]],
                                                        np.int32)]

    @jax.jit
    def ref(p, b):
        logits, cache = jm.prefill(p, b)
        outs = [(logits, cache)]
        for i, tok in enumerate(steps):
            outs.append(jm.decode_step(p, outs[-1][1], tok,
                                       jnp.int32(n_tokens + i)))
        return outs

    want = jax.tree.map(np.asarray, ref(jp, batch))
    logits, cache = tm.prefill(tp, _t(batch))
    W = tm.cfg.max_decoder_len
    assert tuple(cache["self"]["k"].shape)[2] == W
    assert tuple(cache["cross_k"].shape)[2] == F
    got = [(logits, cache)]
    for i, tok in enumerate(steps):
        got.append(tm.decode_step(tp, got[-1][1], torch.from_numpy(tok),
                                  n_tokens + i))
    for (lg, c), (wlg, wc) in zip(got, want):
        np.testing.assert_allclose(_np(lg), wlg, rtol=TOL, atol=TOL)
        _close_tree(c, wc)


def test_decode_from_an_empty_cache_matches_reference(models):
    jm, jp, tm, tp = models["float32"]
    toks = _batch(tm.cfg, seed=4)["tokens"]
    cache, jcache = tm.init_cache(B, F, "cpu"), jm.init_cache(B, F)
    _close_tree(cache, jax.tree.map(np.asarray, jcache), 0.0)
    decode = jax.jit(jm.decode_step)
    for t in range(3):
        logits, cache = tm.decode_step(tp, cache,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       t)
        jlogits, jcache = decode(jp, jcache, toks[:, t:t + 1], jnp.int32(t))
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)
    _close_tree(cache, jax.tree.map(np.asarray, jcache))


def test_generate_reproduces_reference_driver_tokens(models):
    """``repro.launch.serve``'s batch (frames [B, S, 128], then tokens [B,
    min(32, S)] from ``default_rng(0)``) and its loop: jitted prefill,
    then greedy decode with cur = T + i."""
    jm, jp, tm, tp = models["float32"]
    S, gen = 20, 5
    batch = serve.prompt_batch(tm.cfg, B, S, "cpu")
    ri = np.random.default_rng(0)
    ri.integers(0, tm.cfg.vocab_size, (B, S))
    frames = ri.normal(size=(B, S, encdec.FRONTEND_DIM))
    tokens = ri.integers(0, tm.cfg.vocab_size, (B, min(32, S)))
    np.testing.assert_array_equal(batch["frames"].numpy(),
                                  frames.astype(np.float32))
    np.testing.assert_array_equal(batch["tokens"].numpy(), tokens)
    jb = {"frames": jnp.asarray(frames, jnp.float32),
          "tokens": jnp.asarray(tokens, jnp.int32)}
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    logits, cache = prefill(jp, jb)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen):
        logits, cache = decode(jp, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    got, glogits, _ = serve.generate(tm, tp, batch, gen)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, 1)))
    np.testing.assert_allclose(glogits.numpy(), np.asarray(logits),
                               rtol=TOL, atol=TOL)


def test_train_cli_batch_and_loss_match_reference(models):
    """The train CLI's batch: the reference's ``synth_batch`` seeds numpy
    from a threefry draw; from that seed the port draws the same frames,
    tokens and labels, and its loss on them is the reference's."""
    jm, jp, tm, tp = models["float32"]
    rng = jax.random.PRNGKey(5)
    jb = jsynth_batch(jm.cfg, rng, B, 40)
    seed = int(jax.random.randint(rng, (), 0, 2 ** 31 - 1))
    tb = train.synth_batch_from(tm.cfg, np.random.default_rng(seed), B, 40)
    assert set(tb) == {"frames", "tokens", "labels"}
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert tuple(tb["tokens"].shape) == (B, 32)
    np.testing.assert_allclose(float(tm.train_loss(tp, tb)[0]),
                               float(jax.jit(jm.train_loss)(jp, jb)[0]),
                               rtol=TOL, atol=TOL)


def test_bfloat16_loss_grads_and_serving_are_finite(models):
    _, _, tm, tp = models["bfloat16"]
    batch = _t(_batch(tm.cfg, seed=6))
    views = tm.leaf_views(tp)
    leaves = tree_leaves(views)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = tm.train_loss(views, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)
    del batch["labels"]
    got, logits, _ = serve.generate(tm, tp, batch, 3)
    assert tuple(got.shape) == (B, 4) and torch.isfinite(logits).all()


def test_silo_round_with_frames_matches_reference():
    """One ``SiloFedSAE`` round, K=2 silos of up to 3 steps, each step a
    batch of frames and tokens: budgets and L/H bitwise, the round's loss
    and the new global params within 1e-4."""
    jcfg = jget_config(ARCH, smoke=True).replace(dtype="float32")
    tcfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    K, max_steps = 2, 3
    jfed = JSiloFedSAE(jbuild_model(jcfg), K, lr=5e-3, max_steps=max_steps)
    tfed = SiloFedSAE(build_model(tcfg), K, lr=5e-3, max_steps=max_steps,
                      init_params=jax.tree.map(np.asarray, jfed.params),
                      device="cpu")
    ri = np.random.default_rng(7)
    batches = {
        "frames": ri.normal(size=(K, max_steps, B, 24, 128)
                            ).astype(np.float32),
        "tokens": ri.integers(0, tcfg.vocab_size, (K, max_steps, B, 10)
                              ).astype(np.int32)}
    batches["labels"] = batches["tokens"]
    sizes = np.array([300, 700])
    jstats = jfed.run_round({k: jnp.asarray(v) for k, v in batches.items()},
                            sizes)
    tstats = tfed.run_round(batches, sizes)
    assert int(tfed.last_n_steps.sum()) > 0
    np.testing.assert_array_equal(tfed.L, jfed.L)
    np.testing.assert_array_equal(tfed.H, jfed.H)
    np.testing.assert_allclose(tstats["loss"][-1], jstats["loss"][-1],
                               rtol=TOL, atol=TOL)
    _close_tree(tfed.params, jax.tree.map(np.asarray, jfed.params))


def test_encoder_decoder_is_no_local_step_and_no_cli_silo():
    """``from_model`` refuses the encoder-decoder, given its config or its
    ``Model``, with the reference's error; ``fl_train --silo-arch
    whisper-tiny`` raises (its token-only batches have no frames)."""
    cfg = get_config(ARCH, smoke=True)
    for spec in (cfg, build_model(cfg)):
        with pytest.raises(ValueError, match="decoder-only architectures"):
            from_model(spec)
    with pytest.raises(ValueError, match="needs frames"):
        fl_train.main(["--silo-arch", ARCH, "--silos", "2", "--rounds", "1",
                       "--device", "cpu"])
