"""The twin of ``tests/test_smoke_archs.py`` over every architecture the
port serves (``PORTED_ARCHS``: all ten of the reference's ids, the dense
configs, the MoE configs, the Mamba, the jamba hybrid, the VLM and the
encoder-decoder), each against the reference on the CPU.  The batches
follow the reference test's ``make_batch`` shapes, drawn with numpy: the
VLM's P = min(n_patches, S // 4) patches [B, P, 1024] before S - P
tokens, the encoder-decoder's frames [B, S, 128] and min(max_decoder_len,
S) tokens.

For each arch: the reduced smoke config (the reference's, field by
field); the params tree ``params_from_reference`` carries across (its key
paths and shapes, MoE and hybrid trees included); the forward loss, one
SGD train step, prefill then decode, and decode from an empty cache,
first finite at the config's own dtype (bfloat16 compute, as the
reference's test runs), then in float32 against the reference's jitted
run from the same params and tokens at 1e-4 (another summation order;
the routing of the MoE configs agrees exactly,
``tests/test_torch_moe.py``).
The jamba hybrid's prefill also runs past its sliding window (80 > 64
positions), so the ring-buffer roll of the cache and the decode from it
run, against the reference's.  The reference's values come from one
jitted function an arch (``_reference_run``), to keep the file fast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models.api import VLM_FRONTEND_DIM as JVLM_DIM
from repro.models.api import build_model as jbuild_model
from repro.models.encdec import FRONTEND_DIM as JFRONTEND_DIM
from repro.optim import sgd as jsgd
from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import build_model
from repro_torch.optim import sgd
from repro_torch.tree import tree_items
from torch_cases import one_torch_thread  # noqa: F401

B, S = 2, 64
TOL = 1e-4
NEW_ARCHS = ("minitron-8b", "granite-8b", "mistral-large-123b",
             "granite-moe-1b-a400m", "kimi-k2-1t-a32b",
             "jamba-1.5-large-398b", "internvl2-2b", "whisper-tiny")


def _batch(cfg, seq=S, seed=0):
    """The reference test's ``make_batch`` layout at ``seq`` positions,
    drawn with numpy: {"tokens", "labels"} and a VLM's "patches" or an
    encoder-decoder's "frames"."""
    ri = np.random.default_rng(seed)
    ints = lambda n: ri.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    if cfg.is_encoder_decoder:
        T = min(cfg.max_decoder_len, seq)
        return {"frames": ri.normal(size=(B, seq, JFRONTEND_DIM)
                                    ).astype(np.float32),
                "tokens": ints(T), "labels": ints(T)}
    P = min(cfg.n_patches, seq // 4) if cfg.n_patches else 0
    out = {"tokens": ints(seq - P), "labels": ints(seq - P)}
    if P:
        out["patches"] = ri.normal(size=(B, P, JVLM_DIM)).astype(np.float32)
    return out


def _prompt(cfg, seq=S, seed=0):
    """A prompt batch: ``_batch`` without its labels."""
    out = _batch(cfg, seq, seed)
    del out["labels"]
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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


def _prompt_lens(cfg):
    """64 positions, and 80 for a sliding-window arch (past its 64)."""
    return (S, 80) if cfg.attention == "sliding_window" else (S,)


def _reference_run(jm, jp, cfg):
    """Every reference value the float32 checks read, from one jitted
    function (one compile an arch): the loss and aux of the batch, the
    params after one SGD(0.1) step, and for prompts of 64 and 80
    positions the prefill logits and cache, then one greedy decode step's
    logits and cache (its token the prefill's argmax); and the decode of
    token 0 from an empty cache."""
    batch = _batch(cfg)
    prompts = {seq: _prompt(cfg, seq) for seq in _prompt_lens(cfg)}
    opt = jsgd(0.1)

    @jax.jit
    def run(p):
        (loss, met), g = jax.value_and_grad(jm.train_loss, has_aux=True)(
            p, batch)
        p1, _ = opt.update(g, opt.init(p), p)
        out = {"loss": loss, "aux": met.get("aux_loss", jnp.float32(0)),
               "p1": p1}
        for seq, prompt in prompts.items():
            logits, cache = jm.prefill(p, prompt)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            cur = prompt["tokens"].shape[1]
            logits2, cache2 = jm.decode_step(p, cache, tok, jnp.int32(cur))
            out[f"s{seq}"] = (logits, cache, tok, logits2, cache2)
        empty = jm.init_cache(B, S)
        out["empty"] = (empty, jm.decode_step(
            p, empty, jnp.zeros((B, 1), jnp.int32), jnp.int32(0))[0])
        return out

    return jax.tree.map(np.asarray, run(jp))


@pytest.fixture(scope="module", params=PORTED_ARCHS)
def arch_setup(request):
    """Both packages' smoke models, bfloat16 (the config's own) and
    float32, on the reference's params, and the reference's float32
    values (``_reference_run``)."""
    arch = request.param
    out = {"arch": arch}
    for dtype in ("bfloat16", "float32"):
        jcfg = jget_config(arch, smoke=True).replace(dtype=dtype)
        cfg = get_config(arch, smoke=True).replace(dtype=dtype)
        jm, tm = jbuild_model(jcfg), build_model(cfg)
        jp = jm.init(jax.random.PRNGKey(1))
        tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
        out[dtype] = (jm, jp, tm, tp)
    out["ref"] = _reference_run(jm, jp, cfg)
    return out


def test_ported_archs_are_every_decoder_arch():
    assert set(NEW_ARCHS) | {"llama3.2-3b", "falcon-mamba-7b"} == set(
        PORTED_ARCHS) == set(JARCH_IDS)
    assert len(PORTED_ARCHS) == 10


def test_smoke_config_is_reduced(arch_setup):
    arch = arch_setup["arch"]
    for smoke in (False, True):
        j, t = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in j.__dataclass_fields__}
    cfg = get_config(arch, smoke=True)
    assert cfg.n_layers <= 4 and cfg.d_model <= 512
    if cfg.n_experts:
        assert cfg.n_experts <= 4


def test_params_cross_from_the_reference(arch_setup):
    """``params_from_reference`` takes the reference's tree (``init``
    returns the params; the specs stay behind): the port's own init has
    the same key paths, shapes and dtypes."""
    jm, jp, tm, tp = arch_setup["float32"]
    own = tm.init(torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in tree_items(
        jax.tree.map(np.asarray, jp))}
    assert {k: tuple(v.shape) for k, v in tree_items(tp)} == want
    assert {k: tuple(v.shape) for k, v in tree_items(own)} == want
    assert {k: v.dtype for k, v in tree_items(own)} == \
        {k: v.dtype for k, v in tree_items(tp)}
    back = params_to_numpy(tp)
    for k, v in tree_items(jax.tree.map(np.asarray, jp)):
        np.testing.assert_array_equal(dict(tree_items(back))[k], v)


def test_forward_loss_finite(arch_setup):
    arch = arch_setup["arch"]
    _, _, tm, tp = arch_setup["bfloat16"]
    loss, metrics = tm.train_loss(tp, _t(_batch(tm.cfg)))
    assert loss.shape == () and torch.isfinite(loss), (arch, loss)
    aux = metrics.get("aux_loss", torch.zeros(()))
    assert torch.isfinite(aux)
    _, _, tm, tp = arch_setup["float32"]
    loss, metrics = tm.train_loss(tp, _t(_batch(tm.cfg)))
    ref = arch_setup["ref"]
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        float(metrics.get("aux_loss", torch.zeros(()))), ref["aux"],
        rtol=TOL, atol=TOL)


def test_train_step_updates_and_finite(arch_setup):
    """One SGD(0.1) step: params move and stay finite (bfloat16 compute);
    in float32 the loss and every updated leaf match the reference's."""
    arch = arch_setup["arch"]
    for dtype in ("bfloat16", "float32"):
        jm, jp, tm, tp = arch_setup[dtype]
        batch = _batch(tm.cfg)
        opt = sgd(0.1)
        p1, _, loss = make_train_step(tm, opt)(tp, opt.init(tp), _t(batch))
        assert torch.isfinite(loss), arch
        moved = any(not torch.allclose(a, b) for (_, a), (_, b) in zip(
            tree_items(tp), tree_items(p1)))
        assert moved, arch
        for k, v in tree_items(p1):
            assert torch.isfinite(v).all(), (arch, k)
    ref = arch_setup["ref"]
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=TOL, atol=TOL)
    _close_tree(p1, ref["p1"])


def _prefill_decode(arch_setup, dtype, seq, tok=None):
    _, _, tm, tp = arch_setup[dtype]
    prompt = _t(_prompt(tm.cfg, seq))
    logits, cache = tm.prefill(tp, prompt)
    assert tuple(logits.shape) == (B, tm.cfg.vocab_size)
    assert torch.isfinite(logits).all(), arch_setup["arch"]
    if tok is None:
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    logits2, cache2 = tm.decode_step(tp, cache, tok,
                                     prompt["tokens"].shape[1])
    assert tuple(logits2.shape) == (B, tm.cfg.vocab_size)
    assert torch.isfinite(logits2).all(), arch_setup["arch"]
    return logits, cache, logits2, cache2


def test_prefill_then_decode_consistency(arch_setup):
    """Prefill then one greedy decode step: finite and right-shaped at the
    config's dtype; in float32 the logits and caches match the
    reference's (the decode step fed the reference's greedy token).  The
    jamba hybrid's attention layers also prefill 80 positions, past their
    64-position window (the cache keeps the rolled trailing window), and
    decode into the ring buffer."""
    arch = arch_setup["arch"]
    cfg = arch_setup["float32"][2].cfg
    for seq in _prompt_lens(cfg):
        _prefill_decode(arch_setup, "bfloat16", seq)
        jlogits, jcache, jtok, jlogits2, jcache2 = \
            arch_setup["ref"][f"s{seq}"]
        logits, cache, logits2, cache2 = _prefill_decode(
            arch_setup, "float32", seq, torch.from_numpy(jtok.copy()))
        if seq > cfg.window_size:
            assert cache["pos1"]["k"].shape[2] == cfg.window_size, arch
        np.testing.assert_allclose(_np(logits), jlogits, rtol=TOL, atol=TOL)
        _close_tree(cache, jcache)
        np.testing.assert_allclose(_np(logits2), jlogits2, rtol=TOL,
                                   atol=TOL)
        _close_tree(cache2, jcache2)


def test_decode_from_empty_cache(arch_setup):
    arch = arch_setup["arch"]
    for dtype in ("bfloat16", "float32"):
        _, _, tm, tp = arch_setup[dtype]
        cache = tm.init_cache(B, S, "cpu")
        tok = torch.zeros((B, 1), dtype=torch.int32)
        logits, _ = tm.decode_step(tp, cache, tok, 0)
        assert tuple(logits.shape) == (B, tm.cfg.vocab_size)
        assert torch.isfinite(logits).all(), arch
    jcache, jlogits = arch_setup["ref"]["empty"]
    _close_tree(cache, jcache, 0.0)
    np.testing.assert_allclose(_np(logits), jlogits, rtol=TOL, atol=TOL)
