"""The port's decoder-LM serving path against the reference, on the CPU.

Both smoke configs (Llama-3.2-3B's and Falcon-Mamba-7B's) start from the
reference's params (``params_from_reference``) and serve the reference
driver's prompts (``np.random.default_rng(0)``).  Tolerances:

- prefill / decode logits and caches against the reference run op by op
  (``jax.disable_jit``): 1e-4 in float32 (another summation order than
  XLA's), 2e-2 in bfloat16 (the reference's model-level bound,
  ``tests/test_serving.py``, ``tests/test_kernels.py``).  Op by op, because
  under ``jit`` XLA fuses bfloat16 chains and skips roundings, and the
  reference's own jitted and op-by-op bf16 logits differ by 0.023 at one
  of 1,024 smoke-Llama logits, beyond that bound;
- ``generate`` against the reference driver's jitted prefill + greedy
  decode loop (``repro.launch.serve``): the same tokens, exactly, in
  float32.  With --gen >= 4 every step after the prompt overwrites the
  prefill cache's last slot, the reference's serve-cache behaviour.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import check_ported, get_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from torch_cases import one_torch_thread  # noqa: F401

ARCHS = ["llama3.2-3b", "falcon-mamba-7b"]


def _models(arch, dtype):
    jcfg = jget_config(arch, smoke=True).replace(dtype=dtype)
    tcfg = get_config(arch, smoke=True).replace(dtype=dtype)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close_tree(got, want, tol):
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], dict):
            _close_tree(got[k], want[k], tol)
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=tol,
                                       rtol=tol, err_msg=k)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, tol):
    jm, jp, tm, tp = _models(arch, dtype)
    B, S = 2, 16
    tokens = serve.prompt_batch(tm.cfg, B, S, "cpu")["tokens"]
    jtok = jnp.asarray(tokens.numpy())
    logits, cache = tm.prefill(tp, {"tokens": tokens})
    with jax.disable_jit():
        jlogits, jcache = jm.prefill(jp, {"tokens": jtok})
    assert logits.dtype == tm.cfg.compute_dtype
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol,
                               rtol=tol)
    _close_tree(cache, jcache, tol)
    step = np.array([[3], [250]], np.int32)
    for i in range(2):
        logits, cache = tm.decode_step(tp, cache, torch.from_numpy(step),
                                       S + i)
        with jax.disable_jit():
            jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(step),
                                             jnp.int32(S + i))
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=tol,
                                   rtol=tol)
        _close_tree(cache, jcache, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_an_empty_cache_matches_reference(arch):
    """Token-by-token decode from ``init_cache(B, S + 4)`` (the reference's
    teacher-forcing test layout), float32, op by op as above."""
    jm, jp, tm, tp = _models(arch, "float32")
    B, S = 2, 6
    toks = serve.prompt_batch(tm.cfg, B, S, "cpu")["tokens"]
    cache = tm.init_cache(B, S + 4, "cpu")
    jcache = jm.init_cache(B, S + 4)
    _close_tree(cache, jcache, 0.0)
    for t in range(S):
        logits, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        with jax.disable_jit():
            jlogits, jcache = jm.decode_step(
                jp, jcache, jnp.asarray(toks[:, t:t + 1].numpy()),
                jnp.int32(t))
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-4,
                                   rtol=1e-4)
    _close_tree(cache, jcache, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_reproduces_reference_driver_tokens(arch):
    """``repro.launch.serve``'s loop: jitted prefill, then greedy decode
    with cur = S + i; the port's ``generate`` must give the same tokens."""
    jm, jp, tm, tp = _models(arch, "float32")
    B, S, gen = 2, 12, 5
    tokens = serve.prompt_batch(tm.cfg, B, S, "cpu")["tokens"]
    jtokens = jnp.asarray(np.random.default_rng(0).integers(
        0, jm.cfg.vocab_size, (B, S)), jnp.int32)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))

    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    logits, cache = prefill(jp, {"tokens": jtokens})
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen):
        logits, cache = decode(jp, cache, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    got, glogits, times = serve.generate(tm, tp, {"tokens": tokens}, gen)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, gen + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(glogits.numpy(), np.asarray(logits),
                               atol=1e-4, rtol=1e-4)
    assert times["prefill_s"] >= 0 and times["decode_s"] >= 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(gen.shape) == (2, 4)
    out = capsys.readouterr().out
    assert "prefill: 2x8" in out and "decode: 3 steps x batch 2" in out


def test_unported_archs_and_fields_raise_with_their_roadmap_item():
    """Every id of the reference resolves (the VLM and the
    encoder-decoder too), and every architecture field and both scan
    options pass ``check_ported``; an unknown id and a dtype the port does
    not take still raise."""
    assert get_config("internvl2-2b").n_patches == 1024
    assert get_config("whisper-tiny").is_encoder_decoder
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    # MoE is ported: granite-moe resolves and n_experts passes
    assert get_config("granite-moe-1b-a400m").n_experts == 32
    cfg = get_config("falcon-mamba-7b", smoke=True)
    check_ported(get_config("llama3.2-3b", smoke=True).replace(
        n_experts=4, experts_per_token=2))
    for ok in (dict(ssm_scan="sequential"),
               dict(ssm_input_dtype="bfloat16"), dict(n_patches=4),
               dict(is_encoder_decoder=True)):
        check_ported(cfg.replace(**ok))
    for bad in (dict(dtype="float16"), dict(param_dtype="float64"),
                dict(ssm_scan="parallel"), dict(ssm_input_dtype="int8")):
        with pytest.raises(ValueError, match="not ported"):
            check_ported(cfg.replace(**bad))


def test_full_width_configs_are_the_reference_configs():
    for arch in ARCHS:
        for smoke in (False, True):
            j = jget_config(arch, smoke=smoke)
            t = get_config(arch, smoke=smoke)
            assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
                {f: getattr(j, f) for f in j.__dataclass_fields__}
    llama = get_config("llama3.2-3b")
    assert (llama.n_layers, llama.d_model, llama.resolved_head_dim) == (
        28, 3072, 128)
    assert get_config("falcon-mamba-7b").d_inner == 8192
