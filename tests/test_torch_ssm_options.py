"""The selective-scan options ``ssm_scan`` and ``ssm_input_dtype`` (the
Falcon-Mamba smoke config, float32 compute) against the reference on the
CPU.

The reference has three routes for the scan (``repro/models/mamba.py``
``selective_scan``): its Pallas kernel (``use_pallas`` and S >= chunk),
the sequential step loop (``ssm_scan="sequential"`` and S > 1) and the
chunked associative scan (every other case, decode's S = 1 included),
and ``ssm_input_dtype`` is read by the chunked route alone, which rounds
its dBx and C inputs to that dtype.  The port computes the kernel route's
function under either option, so:

- with ``ssm_scan="sequential"``, and with ``ssm_input_dtype="bfloat16"``,
  the mixer's output and final state agree with the reference's
  sequential and kernel routes within 1e-5;
- against the reference's chunked route with bfloat16 inputs the port
  differs by that rounding.  Measured at B=2, S=64 over seeds 0-2: the
  output by 7.7e-3 to 2.2e-2 (0.14-0.47% of its largest magnitude) and
  the state by 9.4e-3 to 2.9e-2 (0.10-0.28%); at decode's S = 1, which
  takes the chunked route under every option, by 1.6e-4 to 2.8e-4 and
  1.2e-3 to 2.5e-3.  The test holds each gap above 1e-5 (a real
  difference) and below one bfloat16 ulp of the reference's largest
  magnitude (2^-7 of it), where the rounding of its inputs puts it;
- the model with both options set builds, prefills and trains as the
  reference's sequential route does, within 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba as JM
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import check_ported, get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import mamba as TM
from repro_torch.models.api import build_model
from repro_torch.tree import tree_leaves, tree_unflatten
from torch_cases import one_torch_thread  # noqa: F401

ARCH = "falcon-mamba-7b"
SEQ, BF16 = dict(ssm_scan="sequential"), dict(ssm_input_dtype="bfloat16")


def _configs(**over):
    jcfg = jget_config(ARCH, smoke=True).replace(dtype="float32", **over)
    tcfg = get_config(ARCH, smoke=True).replace(
        dtype="float32", **{k: v for k, v in over.items()
                            if k not in ("use_pallas", "ssm_chunk")})
    return jcfg, tcfg


@pytest.fixture(scope="module")
def mixer():
    jcfg, _ = _configs()
    p, _ = JM.init_mamba(jax.random.PRNGKey(0), jcfg)
    return p, params_from_reference(jax.tree.map(np.asarray, p), "cpu")


def _run(mixer, over, S, seed=0):
    jp, tp = mixer
    jcfg, tcfg = _configs(**over)
    check_ported(tcfg)
    x = np.random.default_rng(seed).normal(
        size=(2, S, jcfg.d_model)).astype(np.float32)
    jy, jc = jax.jit(lambda p, x: JM.mamba_forward(p, jcfg, x))(jp, x)
    ty, tc = TM.mamba_forward(tp, tcfg, torch.from_numpy(x))
    return ((ty.numpy(), np.asarray(jy)),
            (tc["ssm"].numpy(), np.asarray(jc["ssm"])))


@pytest.mark.parametrize("over", [
    SEQ, dict(SEQ, **BF16), dict(BF16, use_pallas=True, ssm_chunk=16)],
    ids=["sequential", "sequential-bf16", "kernel-bf16"])
def test_options_match_the_references_sequential_and_kernel_routes(
        mixer, over):
    for got, want in _run(mixer, over, 64):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [64, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gap_to_the_references_chunked_bf16_route_is_its_rounding(
        mixer, S, seed):
    """The reference's chunked route rounds dBx and C to bfloat16; the
    port does not.  The gap stays between 1e-5 and 2^-7 of the
    reference's largest magnitude (module docstring)."""
    for got, want in _run(mixer, BF16, S, seed):
        gap = float(np.abs(got - want).max())
        assert 1e-5 < gap <= 2.0 ** -7 * float(np.abs(want).max()), gap


def test_model_with_both_options_matches_the_sequential_reference():
    over = dict(SEQ, **BF16)
    jcfg, tcfg = _configs(**over)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    ri = np.random.default_rng(3)
    toks = ri.integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    labels = ri.integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    jlogits, jcache = jax.jit(jm.prefill)(jp, {"tokens": toks})
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    for got, want in zip(tree_leaves(cache),
                         jax.tree.leaves(jax.tree.map(np.asarray, jcache))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    batch = {"tokens": toks, "labels": labels}
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.train_loss,
                                                has_aux=True))(jp, batch)
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(tp)]
    loss, _ = tm.train_loss(tree_unflatten(tp, leaves),
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-4)
    for got, want in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
