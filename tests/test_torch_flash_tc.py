"""The rounding models of the flash-attention kernels' bfloat16 route, on
the CPU.

On the card, bfloat16 attention runs on the tensor cores, which round the
probabilities P (forward, and the dV product of the backward) and dS (the
dK and dQ products) to bfloat16 before their second product; the reference
keeps them in float32.  ``ref.attention_lse_tc`` and
``ref.flash_attention_bwd_tc`` model that rounding in plain PyTorch.  Here
they are held, on bfloat16 inputs made with numpy from a seed, against the
reference's Pallas ``flash_attention_fwd`` / ``flash_attention_bwd``
(interpret mode) and against the port's float32 plain versions, both at
2e-2, the reference's bfloat16 bound (lse at 2e-5, its float32 bound).  So
the card can hold its kernels to these models at a far tighter bound
(tests/test_torch_cuda.py) while the models stay within the reference's.

Cases: S = 256, Hq = 6 over Hkv = 2 (a GQA group of 3), hd 64 and 128;
causal, causal with a window of 64, and non-causal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bwd as jfa_bwd
from repro.kernels.flash_attention import flash_attention_fwd as jfa_fwd
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from torch_cases import attention_case

TOL = 2e-2                      # the reference's bfloat16 bound
LSE_TOL = 2e-5                  # its float32 lse bound

# (hd, causal, window)
TC_CASES = [(64, True, 0), (128, True, 0), (64, True, 64), (128, True, 64),
            (64, False, 0), (128, False, 0)]


def _inputs(hd, seed=31):
    """q, k, v, do as bfloat16 torch tensors and the same values as
    bfloat16 jax arrays."""
    q, k, v = attention_case(1, 256, 256, 6, 2, hd, seed=seed)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(
        np.float32)
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v, do)]
    jb = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in tb]
    return tb, jb


def _np(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol,
                               err_msg=what)


@pytest.mark.parametrize("hd,causal,window", TC_CASES)
def test_forward_rounding_model_matches_pallas_and_plain(hd, causal, window):
    (q, k, v, _), (jq, jk, jv, _) = _inputs(hd)
    jout, jlse = jfa_fwd(jq, jk, jv, causal=causal, window=window,
                         interpret=True)
    out, lse = tref.attention_lse_tc(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out, _np(jout), TOL, "out vs Pallas")
    _close(lse, _np(jlse), LSE_TOL, "lse vs Pallas")
    f32 = [t.float() for t in (q, k, v)]
    want, want_lse = tref.attention_lse(*f32, causal=causal, window=window)
    _close(out, want.numpy(), TOL, "out vs float32 plain")
    _close(lse, want_lse.numpy(), LSE_TOL, "lse vs float32 plain")
    # the model does round: P in bf16 moves the output off the plain one
    plain_bf16 = tref.attention_lse(q, k, v, causal=causal,
                                    window=window)[0]
    assert not torch.equal(out, plain_bf16)


@pytest.mark.parametrize("hd,causal,window", TC_CASES)
def test_backward_rounding_model_matches_pallas_and_plain(hd, causal,
                                                          window):
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(hd, seed=41)
    jout, jlse = jfa_fwd(jq, jk, jv, causal=causal, window=window,
                         interpret=True)
    want = jfa_bwd(jq, jk, jv, jout, jlse, jdo, causal=causal,
                   window=window, interpret=True)
    out = torch.from_numpy(_np(jout)).bfloat16()
    lse = torch.from_numpy(_np(jlse))
    got = tref.flash_attention_bwd_tc(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    plain = tref.flash_attention_bwd(*[t.float() for t in (q, k, v, out)],
                                     lse, do.float(), causal=causal,
                                     window=window)
    for g, w, p, name in zip(got, want, plain, "qkv"):
        assert g.dtype == torch.bfloat16
        _close(g, _np(w), TOL, f"d{name} vs Pallas")
        _close(g, p.numpy(), TOL, f"d{name} vs float32 plain")


def test_cpu_wrappers_leave_the_tensor_core_counts_alone():
    """A CPU tensor takes the plain version: neither count moves."""
    (q, k, v, do), _ = _inputs(64)
    fwd, bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd
    before = (fwd.launches, fwd.tensor_core_launches, bwd.launches,
              bwd.tensor_core_launches)
    out, lse = fwd(q, k, v, True, 0)
    bwd(q, k, v, out, lse, do, True, 0)
    assert (fwd.launches, fwd.tensor_core_launches, bwd.launches,
            bwd.tensor_core_launches) == before
