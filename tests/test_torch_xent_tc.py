"""The fused cross-entropy's plain versions for the card's kernels, on the
CPU, against the reference.

On the card the forward also returns each row's log-sum-exp, and on the
bfloat16 tensor-core route the backward runs from it: dlogits in float32,
split into bfloat16 hi + lo, both halves' products summed in one float32
accumulator and rounded once (``csrc/fused_xent_bwd.cu``).  Their plain
versions, ``ref.softmax_xent_lse``, ``ref.softmax_xent_dlogits``,
``ref.split_bf16``, ``ref.softmax_xent_bwd`` and the rounding model
``ref.softmax_xent_bwd_tc``, are held here on inputs made with numpy from a
seed against ``jax.vjp`` of the reference's ``ref.softmax_xent`` and
against its Pallas ``fused_softmax_xent_fwd`` in interpret mode:

- float32 values (losses, lse, dlogits, float32 gradients) within 2e-5;
- bfloat16 gradient leaves within one bfloat16 ulp of the reference's
  (with a floor of 2^-20 of the leaf's largest magnitude, for entries that
  cancel to near zero);
- the split identity: ``hi + lo`` equals dlogits within 2^-16 relative.

Sizes: T = 150 and 256 rows, d = 64, V = 700 (not a multiple of 8: the
CUDA-core route on the card) and 704 (the tensor-core route's shape).
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_xent import fused_softmax_xent_fwd as jxent_fwd
from repro_torch.kernels import build
from repro_torch.kernels import fused_xent as tfx
from repro_torch.kernels import ref as tref
from torch_cases import xent_case
from torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-5
CASES = [(T, V) for T in (150, 256) for V in (700, 704)]
DTYPES = ["float32", "bfloat16"]
D = 64
#: Pallas vocabulary blocks that divide V (the TPU kernel asserts it)
BLOCK_V = {700: 140, 704: 176}


def _inputs(T, V, dtype, seed=21):
    """(h, W, labels, g) as torch tensors (h and W in ``dtype``) and h, W,
    labels, g as jax arrays of the same values."""
    h, W, labels = xent_case(T, D, V, seed=seed)
    g = np.random.default_rng(seed + 1).uniform(0.5, 1.5, T).astype(
        np.float32)
    th, tW = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (h, W))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jh, jW = (jnp.asarray(t.float().numpy(), jdt) for t in (th, tW))
    return ((th, tW, torch.from_numpy(labels), torch.from_numpy(g)),
            (jh, jW, jnp.asarray(labels), jnp.asarray(g)))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_within_one_bf16_ulp(got, want, what):
    """|got - want| <= one bfloat16 ulp at the larger magnitude of the two
    (2^(e - 8) for a magnitude in [2^(e-1), 2^e)), plus a floor of
    2^-20 max|want| for the entries that cancel to ~1e-6 of the leaf's
    largest, where the float32 sums' order alone moves them by more than
    their own ulp."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    ulp = np.ldexp(np.float32(1), e - 8) + 2.0 ** -20 * np.abs(want).max()
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (f"{what}: {bad.sum()} entries off by more than "
                           f"one bf16 ulp, worst "
                           f"{np.max(np.abs(got - want) / ulp):.2f} ulp")


@contextlib.contextmanager
def _returns_of(monkeypatch, name):
    """Record every result of the plain ``ref.<name>`` while the block runs,
    so that a test can check that a wrapper returned that very result.
    Comparing the wrapper's output with a second plain call bit for bit is
    not steady: two float32 CPU products of the same operands can differ
    in the last bit when the BLAS library splits them differently (as it
    may under load)."""
    real, calls = getattr(tref, name), []

    def record(*args, **kwargs):
        calls.append(real(*args, **kwargs))
        return calls[-1]
    with monkeypatch.context() as m:
        m.setattr(tref, name, record)
        yield calls


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,V", CASES)
def test_forward_lse_matches_pallas_and_reference(T, V, dtype, monkeypatch):
    (th, tW, tl, _), (jh, jW, jl, _) = _inputs(T, V, dtype)
    loss, lse = tref.softmax_xent_lse(th, tW, tl)
    want = jxent_fwd(jh, jW, jl, block_v=BLOCK_V[V], interpret=True)
    logits = jh.astype(jnp.float32) @ jW.astype(jnp.float32)
    np.testing.assert_allclose(loss.numpy(), _np(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(loss.numpy(), _np(jref.softmax_xent(jh, jW,
                                                                   jl)),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(),
                               _np(jax.nn.logsumexp(logits, axis=-1)),
                               atol=TOL, rtol=TOL)
    # the wrapper takes the plain version on the CPU, launching nothing,
    # and returns that call's very result (two float32 CPU products of the
    # same operands need not agree bit for bit: see ``_returns_of``)
    before = tfx.fused_softmax_xent_fwd.launches
    with _returns_of(monkeypatch, "softmax_xent_lse") as calls:
        w_loss, w_lse = tfx.fused_softmax_xent_fwd_lse(th, tW, tl)
        w_only = tfx.fused_softmax_xent_fwd(th, tW, tl)
    assert tfx.fused_softmax_xent_fwd.launches == before
    assert len(calls) == 2
    assert w_loss is calls[0][0] and w_lse is calls[0][1]
    assert w_only is calls[1][0]


def _reference_vjp(jh, jW, jl, jg):
    _, vjp = jax.vjp(lambda a, b: jref.softmax_xent(a, b, jl), jh, jW)
    return vjp(jg)


@pytest.mark.parametrize("model", ["plain", "tensor_cores"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,V", CASES)
def test_backward_matches_reference_vjp(T, V, dtype, model):
    (th, tW, tl, tg), (jh, jW, jl, jg) = _inputs(T, V, dtype)
    _, lse = tref.softmax_xent_lse(th, tW, tl)
    fn = (tref.softmax_xent_bwd if model == "plain"
          else tref.softmax_xent_bwd_tc)
    got = fn(th, tW, tl, lse, tg)
    want = _reference_vjp(jh, jW, jl, jg)
    for g, w, name in zip(got, want, ("dh", "dW")):
        assert g.dtype == th.dtype and tuple(g.shape) == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), _np(w), atol=TOL,
                                       rtol=TOL, err_msg=name)
        else:
            _assert_within_one_bf16_ulp(g, _np(w), f"{model} {name}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,V", CASES)
def test_dlogits_and_their_split(T, V, dtype):
    (th, tW, tl, tg), (jh, jW, jl, jg) = _inputs(T, V, dtype)
    _, lse = tref.softmax_xent_lse(th, tW, tl)
    dl = tref.softmax_xent_dlogits(th, tW, tl, lse, tg)
    logits = jh.astype(jnp.float32) @ jW.astype(jnp.float32)
    _, vjp = jax.vjp(lambda z: jax.nn.logsumexp(z, axis=-1)
                     - jnp.take_along_axis(z, jl[:, None], axis=-1)[:, 0],
                     logits)
    np.testing.assert_allclose(dl.numpy(), _np(vjp(jg)[0]), atol=TOL,
                               rtol=TOL)
    hi, lo = tref.split_bf16(dl)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.float() + lo.float() - dl).abs()
    assert bool((err <= 2.0 ** -16 * dl.abs()).all()), float(
        (err / dl.abs().clamp_min(1e-30)).max())
    # each row of dlogits sums to zero (up to float32 rounding)
    np.testing.assert_allclose(dl.sum(1).numpy(), 0.0, atol=TOL)


def test_backward_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    (th, tW, tl, tg), _ = _inputs(150, 704, "bfloat16")
    _, lse = tref.softmax_xent_lse(th, tW, tl)
    before = (tfx.fused_softmax_xent_bwd.launches,
              tfx.fused_softmax_xent_bwd.tensor_core_launches)
    with _returns_of(monkeypatch, "softmax_xent_bwd") as calls:
        got = tfx.fused_softmax_xent_bwd(th, tW, tl, lse, tg)
    assert len(calls) == 1 and got is calls[0]
    assert (tfx.fused_softmax_xent_bwd.launches,
            tfx.fused_softmax_xent_bwd.tensor_core_launches) == before
    assert not tfx.tensor_core_route(th, tW)
    with pytest.raises(ValueError, match="unsupported device"):
        tfx.fused_softmax_xent_bwd(*(t.to("meta") for t in (th, tW, tl)),
                                   lse.to("meta"), tg.to("meta"))
    # every CUDA source is built and bound, the backward's included
    sources = {f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu")}
    assert sources == set(build.SIGNATURES)
    assert "fused_xent_bwd_launch" in build.SIGNATURES["fused_xent_bwd"]
