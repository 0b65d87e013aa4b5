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

Sizes: T = 150 and 256 rows, d = 64, V = 700 (not a multiple of 8: in a
contiguous W, the CUDA-core route on the card) and 704 (the tensor-core
route's shape).

An odd vocabulary reaches the tensor cores through a pitched W: the
``[:, :V]`` view of a ``[d, ceil8(V)]`` buffer (``fused_xent.pitched``,
``ops.pitched``).  The plain versions are held on such a view whose pad
columns hold NaN (T = 37, d = 64, V = 1,003) against ``jax.vjp`` of the
reference's ``ref.softmax_xent`` (its Pallas forward asserts V % 512 == 0
here, so it is no oracle), and ``chunked_lm_loss(use_fused=True)`` at
that vocabulary, tied and untied, in float32 (1e-5 the loss, 1e-4 the
grads) and bfloat16 (2e-2, op by op), against the reference's fused loss
body: its ``rms_norm``, ``_unembed_matrix`` and ``ref.softmax_xent``, the
function its ``fused_softmax_xent`` computes and differentiates.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.fused_xent import fused_softmax_xent_fwd as jxent_fwd
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import build
from repro_torch.kernels import fused_xent as tfx
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
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


#: an odd vocabulary (the pitched route's case)
ODD_T, ODD_V = 37, 1003


def _nan_pitched(W):
    """``tfx.pitched(W)`` with its buffer's pad columns set to NaN."""
    P = tfx.pitched(W)
    d, V = P.shape
    torch.as_strided(P, (d, P.stride(0) - V), P.stride(),
                     P.storage_offset() + V).fill_(float("nan"))
    return P


def test_pitched_is_a_view_of_a_padded_buffer():
    for V in (1003, 1000, 1):
        W = torch.randn(5, V)
        P = tfx.pitched(W, torch.bfloat16)
        assert P.shape == W.shape and P.dtype == torch.bfloat16
        assert P.stride() == (tfx.pitch(V), 1) and tfx.pitch(V) % 8 == 0
        assert tfx.pitch(V) - V < 8
        assert torch.equal(P, W.to(torch.bfloat16))
    # on the CPU no route is the tensor cores'
    assert not tfx.tensor_core_route(torch.zeros(3, 8, dtype=torch.bfloat16),
                                     tfx.pitched(torch.zeros(8, 1003,
                                                             dtype=torch.bfloat16)))


def test_ops_pitched_passes_the_gradient_back_in_the_source_dtype():
    W = torch.randn(6, 1003, dtype=torch.float32, requires_grad=True)
    P = tops.pitched(W.T.T, torch.bfloat16)
    assert P.dtype == torch.bfloat16 and P.stride() == (1008, 1)
    g = torch.randn(6, 1003).to(torch.bfloat16)
    (P.float() * g.float()).sum().backward()
    assert W.grad.dtype == torch.float32
    assert torch.equal(W.grad, g.float())


def test_dh_splits_fill_the_waves():
    # Llama's chunk: 8 x 12 tiles of 128 x 256, 4 splits -> 384 items
    assert tfx.dh_splits(1024, 3072, 128256, 132) == 4
    for T, d, V in ((240, 3072, 128256), (1024, 384, 51865),
                    (37, 64, 1003), (1, 128, 1024), (1024, 2048, 92553)):
        s = tfx.dh_splits(T, d, V, 132)
        assert 1 <= s <= -(-V // tfx.TC_BLOCK_K)
        items = -(-T // 128) * -(-d // 256) * s
        assert items / (-(-items // 132) * 132) >= tfx.DH_FILL or \
            s == -(-V // tfx.TC_BLOCK_K)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_at_an_odd_vocabulary_on_a_pitched_view(dtype):
    """The plain forward, backward and rounding model on the ``[:, :V]``
    view of a NaN-padded buffer: the same values as the reference's vjp,
    no NaN from the pad."""
    (th, tW, tl, tg), (jh, jW, jl, jg) = _inputs(ODD_T, ODD_V, dtype)
    pW = _nan_pitched(tW)
    assert pW.stride() == (1008, 1) and torch.equal(pW, tW)
    loss, lse = tref.softmax_xent_lse(th, pW, tl)
    np.testing.assert_allclose(loss.numpy(),
                               _np(jref.softmax_xent(jh, jW, jl)),
                               atol=TOL, rtol=TOL)
    logits = jh.astype(jnp.float32) @ jW.astype(jnp.float32)
    np.testing.assert_allclose(lse.numpy(),
                               _np(jax.nn.logsumexp(logits, axis=-1)),
                               atol=TOL, rtol=TOL)
    want = _reference_vjp(jh, jW, jl, jg)
    for model in (tref.softmax_xent_bwd, tref.softmax_xent_bwd_tc):
        got = model(th, pW, tl, lse, tg)
        for g, w, name in zip(got, want, ("dh", "dW")):
            assert g.dtype == th.dtype and tuple(g.shape) == w.shape
            assert bool(torch.isfinite(g).all()), name
            if dtype == "float32":
                np.testing.assert_allclose(g.numpy(), _np(w), atol=TOL,
                                           rtol=TOL, err_msg=name)
            else:
                _assert_within_one_bf16_ulp(g, _np(w),
                                            f"{model.__name__} {name}")
    # the wrappers take the plain versions on the CPU, pitch and all
    w_loss, w_lse = tfx.fused_softmax_xent_fwd_lse(th, pW, tl)
    np.testing.assert_allclose(w_loss.numpy(), loss.numpy(), atol=TOL,
                               rtol=TOL)
    dh, dW = tfx.fused_softmax_xent_bwd(th, pW, tl, lse, tg)
    assert tuple(dW.shape) == (D, ODD_V) and bool(torch.isfinite(dW).all())


def _jfused_loss(p, jcfg, h, labels, mask):
    """The reference's ``chunked_lm_loss(use_fused=True)`` body for one
    chunk, with the function its ``fused_softmax_xent`` computes (its
    Pallas forward, which asserts V % 512 == 0) and differentiates (its
    ``_fx_bwd``: the vjp of ``ref.softmax_xent``)."""
    B, S, d = h.shape
    hc = JL.rms_norm(h, p["final_norm"], jcfg.norm_eps)
    losses = jref.softmax_xent(hc.reshape(-1, d), JL._unembed_matrix(p, jcfg),
                               labels.reshape(-1)).reshape(B, S)
    return (losses * mask).sum() / jnp.maximum(mask.sum(), 1)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_lm_loss_fused_at_an_odd_vocabulary(dtype, tie):
    jcfg = jget_config("llama3.2-3b", smoke=True).replace(
        dtype=dtype, vocab_size=ODD_V, tie_embeddings=tie)
    tcfg = get_config("llama3.2-3b", smoke=True).replace(
        dtype=dtype, vocab_size=ODD_V, tie_embeddings=tie)
    je, _ = JL.init_embeddings(jax.random.PRNGKey(4), jcfg)
    te = params_from_reference(jax.tree.map(np.asarray, je), device="cpu")
    assert ("unembed" in te) != tie
    rng = np.random.default_rng(5)
    B, S = 2, 24
    h = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, ODD_V, (B, S)).astype(np.int32)
    mask = rng.random((B, S)) > 0.3
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jh = jnp.asarray(h, jdt)
    with jax.disable_jit():
        jloss, (jg_p, jg_h) = jax.value_and_grad(
            lambda p, x: _jfused_loss(p, jcfg, x, jnp.asarray(labels),
                                      jnp.asarray(mask)),
            argnums=(0, 1))(je, jh)
    th = torch.from_numpy(h).to(getattr(torch, dtype)).requires_grad_()
    leaves = {k: v.requires_grad_() for k, v in te.items()}
    loss = TL.chunked_lm_loss(leaves, tcfg, th, torch.from_numpy(labels),
                              torch.from_numpy(mask), use_fused=True)
    # untied, the loss reads no row of "tok": JAX's zeros, torch's None
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        [th, *leaves.values()], torch.autograd.grad(
            loss, [th, *leaves.values()], allow_unused=True))]
    tol, gtol = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=tol, rtol=tol)
    for (k, _), g in zip([("h", None), *leaves.items()], grads):
        want = _np(jg_h if k == "h" else jg_p[k])
        assert tuple(g.shape) == want.shape, k
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.float().numpy(), want,
                                   atol=gtol * scale, rtol=gtol, err_msg=k)
