"""The port's training kernels (their plain versions) and differentiable ops
against the reference, on the CPU.

- The flash-attention backward: ``ref.flash_attention_bwd`` and the
  gradients of the port's autograd ``flash_attention`` against the
  reference's Pallas ``flash_attention_bwd`` (interpret mode) and
  ``jax.grad`` through its oracle ``ref.attention``, in the reference's
  three cases (tests/test_kernels.py) at its bound, atol 2e-5 / rtol 2e-4;
  a ragged S, which the Pallas backward drops (``n_q = S // block_q``),
  against the oracle only.
- The fused cross-entropy: ``ref.softmax_xent`` and the port's
  ``fused_softmax_xent`` against the Pallas ``fused_softmax_xent_fwd``
  (interpret mode, the reference's ``XENT_CASES``) at 1e-4, its gradients
  against ``jax.grad`` at 1e-5 (the reference's bounds); a ragged
  vocabulary, which the Pallas kernel refuses, against the oracle.
- The selective scan's gradients against ``jax.grad`` through the
  reference's ``ops.selective_scan`` (Pallas forward, oracle backward) at
  the scan's 1e-4.

Inputs are made with numpy from a seed and handed to both packages.  The
CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bwd as jfa_bwd
from repro.kernels.flash_attention import flash_attention_fwd as jfa_fwd
from repro.kernels.fused_xent import fused_softmax_xent_fwd as jxent_fwd
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_xent as tfx
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_cases import attention_case, scan_case, xent_case
from torch_cases import one_torch_thread  # noqa: F401

ATOL, RTOL = 2e-5, 2e-4          # the reference's flash-backward bound


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# (Hq, Hkv, causal, window) of the reference's backward test, B=1, S=256,
# hd=32: GQA, MQA + window, non-causal
BWD_CASES = [(4, 2, True, 0), (4, 1, True, 64), (2, 2, False, 0)]


@pytest.mark.parametrize("Hq,Hkv,causal,window", BWD_CASES)
def test_flash_backward_matches_pallas_and_autodiff(Hq, Hkv, causal,
                                                    window):
    B, S, hd = 1, 256, 32
    q, k, v = attention_case(B, S, S, Hq, Hkv, hd, seed=11)
    do = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, jlse = jfa_fwd(jq, jk, jv, causal=causal, window=window)
    pallas = jfa_bwd(jq, jk, jv, jout, jlse, jdo, causal=causal,
                     window=window)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(
        a, b, c, causal=causal, window=window), jq, jk, jv)
    oracle = vjp(jdo)

    out, lse = tref.attention_lse(_t(q), _t(k), _t(v), causal=causal,
                                  window=window)
    plain = tref.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse,
                                     _t(do), causal=causal, window=window)
    for got, name in zip(plain, "qkv"):
        for want in (pallas, oracle):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(want["qkv".index(name)]), atol=ATOL,
                rtol=RTOL, err_msg=f"d{name}")

    # the autograd op, through the reference test's objective
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (tops.flash_attention(tq, tk, tv, causal, window) ** 2).mean().backward()
    grads = jax.grad(lambda a, b, c: (jops.flash_attention(
        a, b, c, causal, window) ** 2).mean(), argnums=(0, 1, 2))(jq, jk, jv)
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


def test_flash_backward_ragged_length_matches_oracle():
    q, k, v = attention_case(2, 100, 100, 4, 2, 32, seed=13)
    do = np.random.default_rng(14).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(
        a, b, c, causal=True, window=24), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    out, lse = tref.attention_lse(_t(q), _t(k), _t(v), causal=True,
                                  window=24)
    got = tref.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(do),
                                   causal=True, window=24)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


def test_flash_backward_bf16_matches_pallas():
    """bf16 inputs: f32 inside, gradients cast once (2e-2, the reference's
    bf16 bound)."""
    q, k, v = attention_case(1, 128, 128, 4, 2, 64, seed=15)
    do = np.random.default_rng(16).normal(size=q.shape).astype(np.float32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do)]
    jout, jlse = jfa_fwd(*jb[:3], causal=True, window=0)
    want = jfa_bwd(*jb[:3], jout, jlse, jb[3], causal=True, window=0)
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in jb]
    out, lse = tref.attention_lse(*tb[:3], causal=True)
    got = tref.flash_attention_bwd(*tb[:3], out, lse, tb[3], causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=2e-2,
                                   rtol=2e-2)


# the reference's XENT_CASES (T, d, V)
XENT_CASES = [(256, 64, 1024), (512, 128, 2048), (256, 32, 512)]


@pytest.mark.parametrize("T,d,V", XENT_CASES)
def test_xent_matches_pallas(T, d, V):
    h, W, labels = xent_case(T, d, V)
    want = jxent_fwd(jnp.asarray(h), jnp.asarray(W), jnp.asarray(labels))
    for got in (tref.softmax_xent(_t(h), _t(W), _t(labels)),
                tops.fused_softmax_xent(_t(h), _t(W), _t(labels))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_xent_grads_match_autodiff():
    """The reference test's case, h and W both differentiated, at its
    1e-5."""
    h, W, labels = xent_case(128, 32, 512)
    th, tW = _t(h, True), _t(W, True)
    tops.fused_softmax_xent(th, tW, _t(labels)).mean().backward()
    gh, gW = jax.grad(lambda a, b: jops.fused_softmax_xent(
        a, b, jnp.asarray(labels)).mean(), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(W))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tW.grad.numpy(), np.asarray(gW), atol=1e-5,
                               rtol=1e-5)


def test_xent_ragged_vocabulary_matches_oracle():
    """V = 1000 (Llama's 128,256 is no multiple of the Pallas tile either):
    the Pallas kernel asserts V % 512 == 0; the port's masks the ragged
    last tile, and its plain version matches the oracle there."""
    h, W, labels = xent_case(96, 48, 1000)
    got = tops.fused_softmax_xent(_t(h), _t(W), _t(labels))
    want = jref.softmax_xent(jnp.asarray(h), jnp.asarray(W),
                             jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(AssertionError):
        jxent_fwd(jnp.asarray(h), jnp.asarray(W), jnp.asarray(labels))


def test_scan_grads_match_autodiff():
    arrays = scan_case(1, 64, 32, 8, seed=17)
    gy = np.random.default_rng(18).normal(size=(1, 64, 32)).astype(
        np.float32)
    ts = [_t(a, True) for a in arrays]
    y, hT = tops.selective_scan(*ts)
    ((y * _t(gy)).sum() + hT.square().sum()).backward()
    want = jax.grad(lambda *a: (
        (jops.selective_scan(*a)[0] * gy).sum()
        + jnp.square(jops.selective_scan(*a)[1]).sum()),
        argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    for t, w, name in zip(ts, want, ("dt", "A", "B", "C", "x", "h0")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_training_wrappers_take_the_plain_version_on_the_cpu():
    tfa.flash_attention_bwd.launches = 0
    tfx.fused_softmax_xent_fwd.launches = 0
    q, k, v = (_t(a) for a in attention_case(1, 8, 8, 2, 1, 16))
    out, lse = tfa.flash_attention_fwd(q, k, v, True, 0)
    tfa.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(q))
    h, W, labels = (_t(a) for a in xent_case(8, 4, 10))
    tfx.fused_softmax_xent_fwd(h, W, labels)
    assert tfa.flash_attention_bwd.launches == 0
    assert tfx.fused_softmax_xent_fwd.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tfx.fused_softmax_xent_fwd(h.to("meta"), W.to("meta"),
                                   labels.to("meta"))
    assert {"flash_attention_bwd", "fused_xent"} <= set(build.SIGNATURES)


def test_xent_splits_cover_the_vocabulary():
    """The card's grid: every split owns >= 1 vocabulary tile."""
    for T, V, n_sm in ((1024, 128256, 132), (64, 512, 132), (5000, 300, 8),
                       (1, 1, 132)):
        s = tfx.n_splits(T, V, n_sm)
        assert 1 <= s <= -(-V // tfx.BLOCK_V)
    assert tfx.n_splits(1024, 128256, 132) == 66
