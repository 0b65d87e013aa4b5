"""The port's LM kernels and blocks against the reference, on the CPU.

The plain versions of the flash-attention forward and the selective scan
(``repro_torch.kernels.ref``) are held against the reference's Pallas
kernels (interpret mode, via ``repro.kernels.ops``) and its jnp oracles
(``repro.kernels.ref``) on the same numpy-made inputs; then the blocks
that call them (``models/layers.py``, ``models/mamba.py``) against the
reference's, at the smoke configs, with the reference's params injected.

Tolerances are the reference's own (``tests/test_kernels.py``): attention
2e-5 in float32 and 2e-2 in bfloat16, the scan 1e-4.  Blocks in float32
sum in another order than XLA, so they are held at 1e-4.

The hand-written CUDA kernels run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jfa_fwd
from repro.models import layers as JL
from repro.models import mamba as JMb
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as tss
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMb
from torch_cases import attention_case, scan_case
from torch_cases import one_torch_thread  # noqa: F401

TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

# (B, S, T, Hq, Hkv, hd, causal, window, dtype): GQA, window + GQA,
# non-causal, and bf16 with a window, from tests/test_kernels.py
ATTN_CASES = [
    (2, 256, 256, 4, 2, 64, True, 0, jnp.float32),
    (2, 256, 256, 4, 1, 64, True, 64, jnp.float32),
    (1, 128, 128, 8, 8, 32, False, 0, jnp.float32),
    (1, 256, 256, 2, 2, 128, True, 128, jnp.bfloat16),
]


def _both(arrays, jdtype):
    """numpy arrays -> (jax arrays, torch tensors), both of ``jdtype``."""
    ja = [jnp.asarray(a, jdtype) for a in arrays]
    ta = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(TDT[jdtype])
          for a in ja]
    return ja, ta


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window,dtype", ATTN_CASES)
def test_attention_matches_pallas_and_oracle(B, S, T, Hq, Hkv, hd, causal,
                                             window, dtype, monkeypatch):
    (jq, jk, jv), (q, k, v) = _both(
        attention_case(B, S, T, Hq, Hkv, hd), dtype)
    out, lse = tref.attention_lse(q, k, v, causal=causal, window=window)
    assert out.dtype == TDT[dtype] and lse.dtype == torch.float32
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    got = out.to(torch.float32).numpy()
    for want in (jops.flash_attention(jq, jk, jv, causal, window),
                 jref.attention(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    _, jlse = jfa_fwd(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-4,
                               rtol=1e-5)
    # the op takes the plain version on the CPU and returns that call's very
    # output: a second plain call need not agree with the first bit for bit
    # (its float32 CPU products may be split differently under load)
    real, calls = tref.attention_lse, []

    def record(*args, **kwargs):
        calls.append(real(*args, **kwargs))
        return calls[-1]
    monkeypatch.setattr(tref, "attention_lse", record)
    got_op = tops.flash_attention(q, k, v, causal, window)
    assert len(calls) == 1 and got_op is calls[0][0]


def test_attention_ragged_length_matches_oracle():
    """S = 100: the Pallas kernel asserts divisibility by its tile; the
    port's kernel masks the ragged edge, and its plain version matches the
    oracle there."""
    (jq, jk, jv), (q, k, v) = _both(attention_case(1, 100, 100, 4, 2, 32),
                                    jnp.float32)
    got = tref.attention(q, k, v, causal=True, window=16)
    want = jref.attention(jq, jk, jv, causal=True, window=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("B,S,d,N", [(1, 256, 128, 8), (2, 128, 96, 16)])
def test_selective_scan_matches_pallas_and_oracle(B, S, d, N):
    arrays = scan_case(B, S, d, N)
    ja = [jnp.asarray(a) for a in arrays]
    y, hT = tops.selective_scan(*[torch.from_numpy(a) for a in arrays])
    for ye, hTe in (jops.selective_scan(*ja), jref.selective_scan(*ja)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ye), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(hT.numpy(), np.asarray(hTe), atol=1e-4,
                                   rtol=1e-4)


def test_selective_scan_single_step_and_empty_sequence():
    arrays = scan_case(2, 1, 40, 8)
    ja = [jnp.asarray(a) for a in arrays]
    y, hT = tref.selective_scan(*[torch.from_numpy(a) for a in arrays])
    ye, hTe = jref.selective_scan(*ja)
    np.testing.assert_allclose(y.numpy(), np.asarray(ye), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hTe), atol=1e-5)
    empty = [a[:, :0] if a.ndim == 3 and a.shape[1] == 1 else a
             for a in arrays]
    y0, h0 = tref.selective_scan(*[torch.from_numpy(a) for a in empty])
    assert tuple(y0.shape) == (2, 0, 40)
    np.testing.assert_array_equal(h0.numpy(), arrays[-1])


# (B, S, d, N): N below, at and above a multiple of the kernel's 4 lanes
# per channel, N = 1 and 64, S = 1 and S not a multiple of its 16-step
# chunk (the Pallas kernel needs d <= 128 or a multiple of 128)
LANE_CASES = [(2, 40, 96, 3), (1, 256, 128, 17), (2, 1, 40, 16),
              (1, 64, 64, 64), (2, 33, 50, 1)]


@pytest.mark.parametrize("B,S,d,N", LANE_CASES)
def test_selective_scan_lane_model_matches_pallas_and_oracle(B, S, d, N):
    """The plain model of the card kernel's order of operations (exp2 with
    log2 e folded into A; each channel's states split over 4 lanes, summed
    by the kernel's shuffle tree) is held to the reference's 1e-4."""
    arrays = scan_case(B, S, d, N)
    ja = [jnp.asarray(a) for a in arrays]
    y, hT = tref.selective_scan_lanes(*[torch.from_numpy(a)
                                        for a in arrays])
    assert y.shape == (B, S, d) and hT.shape == (B, d, N)
    for ye, hTe in (jops.selective_scan(*ja), jref.selective_scan(*ja)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ye), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(hT.numpy(), np.asarray(hTe), atol=1e-4,
                                   rtol=1e-4)


def test_lm_wrappers_take_the_plain_version_on_the_cpu():
    tfa.flash_attention_fwd.launches = 0
    tss.selective_scan_fwd.launches = 0
    q, k, v = (torch.from_numpy(a) for a in attention_case(1, 8, 8, 2, 1,
                                                           16))
    tfa.flash_attention_fwd(q, k, v, True, 0)
    tss.selective_scan_fwd(*[torch.from_numpy(a)
                             for a in scan_case(1, 4, 8, 4)])
    assert tfa.flash_attention_fwd.launches == 0
    assert tss.selective_scan_fwd.launches == 0
    assert tss.selective_scan_fwd.single_step_launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    assert {"flash_attention", "selective_scan"} <= set(build.SIGNATURES)


# ---------------------------------------------------------------------------
# blocks, with the reference's params injected
# ---------------------------------------------------------------------------


def _cfgs(arch, **kw):
    return (jget_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    gamma = rng.normal(size=16).astype(np.float32)
    for jdt in (jnp.float32, jnp.bfloat16):
        (jx, jg), (tx, tg) = _both([x, gamma], jdt)
        np.testing.assert_allclose(
            _np(TL.rms_norm(tx, tg.float())),
            _np(JL.rms_norm(jx, jg.astype(jnp.float32))),
            atol=1e-5 if jdt == jnp.float32 else 2e-2, rtol=1e-5)
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 11, 500, 2047]], np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_attention_ffn_and_logits_blocks_match_reference(dtype, tol):
    jcfg, tcfg = _cfgs("llama3.2-3b", dtype=dtype)
    ja, _ = JL.init_attention(jax.random.PRNGKey(0), jcfg)
    jf, _ = JL.init_ffn(jax.random.PRNGKey(1), jcfg)
    je, _ = JL.init_embeddings(jax.random.PRNGKey(2), jcfg)
    ta, tf, te = (params_from_reference(jax.tree.map(np.asarray, p),
                                        device="cpu") for p in (ja, jf, je))
    B, S = 2, 24
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    (jx,), (tx,) = _both([x], jnp.dtype(dtype).type)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    tpos = torch.from_numpy(pos.copy())

    out, (k, v) = TL.attn_forward(ta, tcfg, tx, tpos)
    jout, (jk, jv) = JL.attn_forward(ja, jcfg, jx, jnp.asarray(pos))
    for g, w in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)

    np.testing.assert_allclose(_np(TL.ffn_forward(tf, tcfg, tx)),
                               _np(JL.ffn_forward(jf, jcfg, jx)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(TL.logits_fn(te, tcfg, tx[:, -1])),
                               _np(JL.logits_fn(je, jcfg, jx[:, -1])),
                               atol=tol, rtol=tol)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(TL.embed_tokens(te, tcfg, torch.from_numpy(toks))),
        _np(JL.embed_tokens(je, jcfg, jnp.asarray(toks))))

    # decode into a cache that is full: the token lands in the last slot
    cache = {"k": k.to(tcfg.compute_dtype), "v": v.to(tcfg.compute_dtype)}
    jcache = {"k": jk.astype(jcfg.compute_dtype),
              "v": jv.astype(jcfg.compute_dtype)}
    xd = x[:, :1] * 0.5
    (jxd,), (txd,) = _both([xd], jnp.dtype(dtype).type)
    for cur in (S - 3, S, S + 5):
        o, c = TL.attn_decode(ta, tcfg, txd, cache, cur)
        jo, jc = JL.attn_decode(ja, jcfg, jxd, jcache, jnp.int32(cur))
        np.testing.assert_allclose(_np(o), _np(jo), atol=tol, rtol=tol)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(c[name]), _np(jc[name]),
                                       atol=tol, rtol=tol)


def test_sliding_window_cache_and_decode_match_reference():
    jcfg, tcfg = _cfgs("llama3.2-3b", dtype="float32",
                       attention="sliding_window", window_size=8)
    ja, _ = JL.init_attention(jax.random.PRNGKey(4), jcfg)
    ta = params_from_reference(jax.tree.map(np.asarray, ja), device="cpu")
    rng = np.random.default_rng(5)
    cache = TL.attn_cache_init(tcfg, 1, 64, device="cpu")
    jcache = JL.attn_cache_init(jcfg, 1, 64)
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape)
    for t in range(12):
        x = rng.normal(size=(1, 1, jcfg.d_model)).astype(np.float32)
        o, cache = TL.attn_decode(ta, tcfg, torch.from_numpy(x), cache, t)
        jo, jcache = JL.attn_decode(ja, jcfg, jnp.asarray(x), jcache,
                                    jnp.int32(t))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba_forward_and_decode_match_reference(use_pallas):
    """The reference runs its chunked scan (use_pallas off) or its Pallas
    kernel in interpret mode (on, ssm_chunk=64, S=128); the port runs its
    step loop on the CPU either way.  In float32, where the point is the
    algorithm: in bfloat16 the two frameworks round the chain (matmul,
    conv, silu, softplus, gate) at other places, and block outputs of
    magnitude ~5 differ by 2 bf16 ulps (0.06); the bf16 model is held at
    the logits (tests/test_torch_serve.py)."""
    dtype, tol = "float32", 1e-4
    jcfg, tcfg = _cfgs("falcon-mamba-7b", dtype=dtype, ssm_chunk=64)
    jcfg = jcfg.replace(use_pallas=use_pallas)
    jp, _ = JMb.init_mamba(jax.random.PRNGKey(0), jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    B, S = 2, 128
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(B, S, jcfg.d_model)) * 0.5).astype(np.float32)
    (jx,), (tx,) = _both([x], jnp.dtype(dtype).type)
    out, cache = TMb.mamba_forward(tp, tcfg, tx)
    jout, jcache = JMb.mamba_forward(jp, jcfg, jx)
    np.testing.assert_allclose(_np(out), _np(jout), atol=tol, rtol=tol)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   atol=tol, rtol=tol)
    for t in range(3):
        xd = (rng.normal(size=(B, 1, jcfg.d_model)) * 0.5).astype(np.float32)
        (jxd,), (txd,) = _both([xd], jnp.dtype(dtype).type)
        o, cache = TMb.mamba_decode(tp, tcfg, txd, cache, S + t)
        jo, jcache = JMb.mamba_decode(jp, jcfg, jxd, jcache, S + t)
        np.testing.assert_allclose(_np(o), _np(jo), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(cache["ssm"]), _np(jcache["ssm"]),
                                   atol=tol, rtol=tol)
