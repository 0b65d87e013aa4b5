"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the same params (``params_from_reference``) and
inputs, on the CPU.

Routing first, for equality: the top-k expert ids, the kept assignments
and their buffer slots (``dest``), so that a near-tie flipped by another
matmul order shows as a routing fault and not as a loose tolerance.  The
reference's routing is recomputed from its own ops (``rms_norm``,
``lax.top_k``, the stable-argsort bookkeeping of ``moe_forward``).  Then
out and aux: 1e-5 in float32, 2e-2 in bfloat16 (the reference's
model-level bound, run op by op under ``jax.disable_jit`` as
``tests/test_torch_serve.py`` explains), the output's atol scaled by its
largest magnitude (the expert outputs reach ~20 and the k-weighted sum
can cancel to ~0.3, so another summation order leaves ~1e-5 there);
gradients of every param and of ``x`` 1e-4; the decoder's train loss
with its aux term 1e-4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import moe
from repro_torch.models.api import build_model
from repro_torch.models.decoder import layer_views
from repro_torch.tree import tree_items
from torch_cases import one_torch_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"


def _case(dtype="float32", B=2, S=16, seed=0, **over):
    jcfg = jget_config(ARCH, smoke=True).replace(dtype=dtype, **over)
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype, **over)
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed + 1).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    return jcfg, cfg, jp, tp, jx, tx


def reference_routing(jp, jcfg, jx):
    """(eidx [B, S, k], dest [B, S*k], keep [B, S*k]) by the reference's
    own ops, ``moe_forward``'s routing and bookkeeping at M = 1."""
    B, S, _ = jx.shape
    E, k = jcfg.n_experts, jcfg.experts_per_token
    C = jmoe.moe_capacity(jcfg, S)
    h = jL.rms_norm(jx, jp["norm"], jcfg.norm_eps)
    probs = jax.nn.softmax(h.astype(jnp.float32) @ jp["router"], axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    eflat = eidx.reshape(B, S * k)
    order = jnp.argsort(eflat, axis=-1, stable=True)
    inv = jnp.argsort(order, axis=-1)
    sorted_e = jnp.take_along_axis(eflat, order, axis=-1)
    counts = jax.vmap(lambda e: jnp.bincount(e, length=E))(eflat)
    starts = jnp.cumsum(counts, axis=-1) - counts
    pos = jnp.arange(S * k)[None, :] - jnp.take_along_axis(
        starts, sorted_e, axis=-1)
    keep = jnp.take_along_axis(pos < C, inv, axis=-1)
    slot = jnp.take_along_axis(sorted_e * C + jnp.minimum(pos, C - 1), inv,
                               axis=-1)
    dest = jnp.where(keep, slot, E * C)
    return np.asarray(eidx), np.asarray(dest), np.asarray(keep)


def _np(t):
    return (t.detach().to(torch.float32).numpy() if torch.is_tensor(t)
            else np.asarray(jnp.asarray(t, jnp.float32)))


@pytest.mark.parametrize("B,S,over", [
    (2, 16, {}),                              # the smoke config
    (2, 16, dict(capacity_factor=0.25)),      # forced overflow
    (3, 1, {}),                               # decode: S = 1
    (1, 24, dict(n_experts=8, experts_per_token=3)),
])
def test_routing_is_the_reference_routing(B, S, over):
    jcfg, cfg, jp, tp, jx, tx = _case(B=B, S=S, **over)
    assert moe.moe_capacity(cfg, S) == jmoe.moe_capacity(jcfg, S)
    want_e, want_dest, want_keep = reference_routing(jp, jcfg, jx)
    gates, eidx, _ = moe.route(tp, cfg, tx)
    np.testing.assert_array_equal(eidx.numpy(), want_e)
    dest, keep = moe.assign(eidx, cfg.n_experts, moe.moe_capacity(cfg, S))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    # every kept slot is one assignment's
    kept = dest.numpy()[keep.numpy()]
    for b in range(B):
        row = dest.numpy()[b][keep.numpy()[b]]
        assert len(set(row.tolist())) == len(row)
    assert kept.size
    if over.get("capacity_factor") == 0.25:
        assert (~keep).any()
    if S == 1:                  # a token's k experts are distinct
        assert keep.all()
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,over", [
    (2, 16, {}), (2, 16, dict(capacity_factor=0.25)), (3, 1, {})])
def test_moe_forward_matches_reference(dtype, tol, B, S, over):
    jcfg, cfg, jp, tp, jx, tx = _case(dtype, B=B, S=S, **over)
    with jax.disable_jit():
        want, want_aux = jmoe.moe_forward(jp, jcfg, jx)
    got, aux = moe.moe_forward(tp, cfg, tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    scale = max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol * scale)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-5)


def test_decode_capacity_of_the_full_width_configs():
    """At S = 1 the reference's capacity is max(1, ceil(k/E * 1.25)): 1
    for granite-moe (8/32) and kimi-k2 (8/384), 1 for jamba (2/16)."""
    for arch in (ARCH, "kimi-k2-1t-a32b", "jamba-1.5-large-398b"):
        cfg, jcfg = get_config(arch), jget_config(arch)
        for S in (1, 2048):
            assert moe.moe_capacity(cfg, S) == jmoe.moe_capacity(jcfg, S)
        assert moe.moe_capacity(cfg, 1) == 1
    assert moe.moe_capacity(get_config(ARCH), 2048) == math.ceil(
        2048 * 8 / 32 * 1.25)


@pytest.mark.parametrize("over", [{}, dict(capacity_factor=0.25)])
def test_moe_gradients_match_reference(over):
    """d/d(params, x) of sum(out * cot) + aux, float32, 1e-4."""
    jcfg, cfg, jp, tp, jx, tx = _case(**over)
    cot = np.random.default_rng(9).normal(size=jx.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_forward(p, jcfg, x)
        return jnp.sum(out * cot) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = dict(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    tx.requires_grad_(True)
    out, aux = moe.moe_forward(leaves, cfg, tx)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    for k, w in jax.tree.map(np.asarray, jgp).items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", [ARCH, "jamba-1.5-large-398b"])
def test_train_loss_carries_the_aux_term(arch):
    """The decoder's train loss adds 0.01 * aux / n_layers; loss,
    "lm_loss" (the same total, as in the reference) and "aux_loss" match
    the reference's, and the gradients of the MoE leaves too."""
    jcfg = jget_config(arch, smoke=True).replace(dtype="float32")
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jm, tm = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    (jl, jmet), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    leaves = dict(tree_items(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    loss, met = tm.train_loss(tp, tb)
    loss.backward()
    assert float(met["aux_loss"].detach()) > 0
    loss, aux = float(loss.detach()), float(met["aux_loss"].detach())
    for got, want in ((loss, jl), (float(met["lm_loss"].detach()),
                                   jmet["lm_loss"]),
                      (aux, jmet["aux_loss"])):
        np.testing.assert_allclose(got, float(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        loss - aux * 0.01 / cfg.n_layers,
        float(jl) - float(jmet["aux_loss"]) * 0.01 / jcfg.n_layers,
        rtol=1e-4, atol=1e-4)
    jgrads = dict(tree_items(jax.tree.map(np.asarray, jg)))
    moe_keys = [k for k in leaves if "/ffn/" in k and (
        "router" in k or "w_" in k)]
    assert moe_keys
    for k in moe_keys:
        np.testing.assert_allclose(leaves[k].grad.numpy(), jgrads[k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_layer_views_split_the_expert_stacks_per_group():
    """The silo round's per-layer leaves: a [G, E, d, f] expert stack
    becomes G views [E, d, f] of the same storage."""
    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    w = params["blocks"]["pos1"]["ffn"]["w_gate"]
    G = cfg.n_layers // cfg.attn_period
    assert tuple(w.shape) == (G, cfg.n_experts, cfg.d_model, cfg.d_ff)
    views = layer_views(params)["blocks"]["pos1"]["ffn"]["w_gate"]
    assert len(views) == G
    for g, v in enumerate(views):
        assert tuple(v.shape) == tuple(w.shape[1:])
        assert v.data_ptr() == w[g].data_ptr()
    assert "ffn" in params["blocks"]["pos0"] and \
        "router" not in params["blocks"]["pos0"]["ffn"]
