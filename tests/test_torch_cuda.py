"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Every test here is marked ``cuda`` and skips
without a card; the file imports neither JAX nor the reference, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the gather and the compressor are bitwise; MCLR local SGD
rtol = atol = 2e-5 (the reference's kernel-vs-XLA bound); dense-MLP local
SGD rtol 5e-4, atol 5e-5 (the reference's MLP pallas-vs-xla bound); flash
attention 2e-5 in float32 and 2e-2 in bfloat16, its backward atol 2e-5 /
rtol 2e-4 in float32 and 2e-2 in bfloat16, the selective scan 1e-4, the
fused cross-entropy 1e-4 (the reference's kernel-vs-oracle bounds,
tests/test_kernels.py).  The three differentiable ops' gradients on the
card are held against the same ops on the CPU (their plain versions) at
1e-4.  In bfloat16 the flash kernels run on the tensor cores and are also
held to their rounding models (``ref.attention_lse_tc``,
``ref.flash_attention_bwd_tc``, which round P and dS to bfloat16 where the
kernels do) at rtol 2^-7 (one bfloat16 ulp) and atol 4e-3.  The fused
cross-entropy's bfloat16 tensor-core backward (dlogits split into bf16 hi +
lo, each gradient rounded once) is held per leaf to the plain recompute and
to its rounding model ``ref.softmax_xent_bwd_tc`` at rtol 2^-7 and atol
2^-9 max|want|.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (fed_compress, fed_gather, fed_local_sgd,
                                 fed_local_sgd_dense, flash_attention,
                                 fused_xent, selective_scan)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_cases import (attention_case, dense_case, gather_case, scan_case,
                         sgd_case, xent_case)

TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_gather_kernel_bitwise_vs_plain(cuda_device):
    flat, flat_y, starts, ns, max_n = gather_case()
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (flat, flat_y, starts, ns)]
    before = fed_gather.fed_cohort_gather.launches
    got = fed_gather.fed_cohort_gather(*t, max_n)
    want = tref.fed_cohort_gather(*t, max_n=max_n)
    assert fed_gather.fed_cohort_gather.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("prox_mu", [0.0, 0.2])
def test_cuda_local_sgd_kernel_vs_plain(cuda_device, prox_mu):
    t = [torch.from_numpy(a).to(cuda_device) for a in sgd_case()]
    before = fed_local_sgd.fed_local_sgd_mclr.launches
    got = fed_local_sgd.fed_local_sgd_mclr(*t, 0.1, prox_mu)
    want = tref.fed_local_sgd_mclr(*t, lr=0.1, prox_mu=prox_mu)
    assert fed_local_sgd.fed_local_sgd_mclr.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_cuda_dense_sgd_kernel_vs_plain(cuda_device, prox_mu):
    t = [torch.from_numpy(a).to(cuda_device) for a in dense_case()]
    before = fed_local_sgd_dense.fed_local_sgd_dense.launches
    got = fed_local_sgd_dense.fed_local_sgd_dense(*t, 0.1, prox_mu)
    want = tref.fed_local_sgd_dense(*t, lr=0.1, prox_mu=prox_mu)
    assert fed_local_sgd_dense.fed_local_sgd_dense.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 7, 50, 257])
def test_cuda_compress_kernel_bitwise_vs_plain(cuda_device, k):
    rng = np.random.default_rng(k)
    ef = rng.normal(size=(4, 257)).astype(np.float32)
    ef[0, rng.choice(257, 60, replace=False)] = 1.5     # threshold ties
    ef[1] = 0.0
    ef[2, 9] = -8.0
    t = torch.from_numpy(ef).to(cuda_device)
    before = fed_compress.fed_compress_topk_q8.launches
    q, scale = fed_compress.fed_compress_topk_q8(t, k)
    wq, ws = tref.fed_compress_topk_q8(t, k=k)
    assert fed_compress.fed_compress_topk_q8.launches == before + 1
    assert torch.equal(q, wq) and torch.equal(scale, ws)


# (B, S, T, Hq, Hkv, hd, causal, window, dtype): GQA, window, non-causal,
# ragged S and T off the 64-row tile, S = 1, S != T, head dims 32-128, in
# float32 (CUDA cores) and bfloat16 (tensor cores; hd 48 and 20 exercise
# the zero-padded head dim)
FLASH_CASES = [
    (1, 128, 128, 2, 2, 32, True, 0, torch.float32),
    (2, 256, 256, 4, 1, 64, True, 64, torch.float32),
    (1, 128, 128, 8, 8, 32, False, 0, torch.float32),
    (1, 1000, 1000, 4, 2, 128, True, 0, torch.float32),
    (2, 1, 1, 4, 2, 128, True, 0, torch.float32),
    (1, 77, 100, 4, 2, 48, False, 0, torch.float32),
    (1, 256, 256, 2, 2, 128, True, 128, torch.bfloat16),
    (1, 300, 300, 24, 8, 128, True, 0, torch.bfloat16),
    (1, 128, 128, 2, 2, 32, True, 0, torch.bfloat16),
    (1, 77, 100, 4, 2, 48, False, 0, torch.bfloat16),
    (2, 256, 256, 4, 1, 64, True, 64, torch.bfloat16),
    (1, 100, 77, 4, 2, 64, True, 0, torch.bfloat16),
    (2, 1, 1, 4, 2, 128, True, 0, torch.bfloat16),
    (1, 1000, 1000, 4, 2, 128, True, 0, torch.bfloat16),
    (1, 200, 200, 8, 8, 128, False, 0, torch.bfloat16),
    (1, 64, 64, 2, 1, 20, True, 0, torch.bfloat16),
]
# the bf16 route (tensor cores) against its rounding model: one bf16 ulp
MODEL_RTOL, MODEL_ATOL = 2 ** -7, 4e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window,dtype", FLASH_CASES)
def test_cuda_flash_attention_kernel_vs_plain(cuda_device, B, S, T, Hq, Hkv,
                                              hd, causal, window, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in attention_case(B, S, T, Hq, Hkv, hd))
    fa = flash_attention.flash_attention_fwd
    before, before_tc = fa.launches, fa.tensor_core_launches
    out, lse = fa(q, k, v, causal, window)
    want, want_lse = tref.attention_lse(q, k, v, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert fa.launches == before + 1
    assert fa.tensor_core_launches == before_tc + bf16
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert out.shape == q.shape
    tol = 2e-2 if bf16 else 2e-5
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    if bf16:
        model, model_lse = tref.attention_lse_tc(q, k, v, causal=causal,
                                                 window=window)
        torch.testing.assert_close(out.float(), model.float(),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)
        torch.testing.assert_close(lse, model_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_does_not_take(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attention_case(1, 8, 8, 2, 1, 16))
    with pytest.raises(TypeError):
        flash_attention.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_fwd(q.transpose(1, 2), k, v)
    big = torch.zeros((1, 8, 2, 160), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_fwd(big, big[:, :, :1].contiguous(),
                                            big[:, :, :1].contiguous())


# (B, S, d, N): one chunk, ragged S and d, decode's S = 1, N = 64, N = 3
SCAN_CASES = [
    (1, 256, 128, 8),
    (2, 300, 200, 16),
    (4, 1, 256, 16),
    (1, 64, 96, 64),
    (2, 40, 50, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d,N", SCAN_CASES)
def test_cuda_selective_scan_kernel_vs_plain(cuda_device, B, S, d, N):
    t = [torch.from_numpy(a).to(cuda_device) for a in scan_case(B, S, d, N)]
    ss = selective_scan.selective_scan_fwd
    before = ss.launches
    y, hT = ss(*t)
    want_y, want_h = tref.selective_scan(*t)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hT, want_h, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,window,dtype", FLASH_CASES)
def test_cuda_flash_attention_bwd_kernel_vs_plain(cuda_device, B, S, T, Hq,
                                                  Hkv, hd, causal, window,
                                                  dtype):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in attention_case(B, S, T, Hq, Hkv, hd))
    do = torch.from_numpy(np.random.default_rng(3).normal(
        size=q.shape).astype(np.float32)).to(cuda_device, dtype)
    out, lse = tref.attention_lse(q, k, v, causal=causal, window=window)
    bwd = flash_attention.flash_attention_bwd
    before, before_tc = bwd.launches, bwd.tensor_core_launches
    got = bwd(q, k, v, out, lse, do, causal, window)
    want = tref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                    window=window)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert bwd.launches == before + 1
    assert bwd.tensor_core_launches == before_tc + bf16
    atol, rtol = (2e-2, 2e-2) if bf16 else (2e-5, 2e-4)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol)
    if bf16:
        model = tref.flash_attention_bwd_tc(q, k, v, out, lse, do,
                                            causal=causal, window=window)
        for g, m in zip(got, model):
            torch.testing.assert_close(g.float(), m.float(),
                                       rtol=MODEL_RTOL, atol=MODEL_ATOL)


# (T, d, V, dtype): the reference's cases, a ragged vocabulary, rows off
# the 128-row tile, bf16, one row
XENT_CASES = [
    (256, 64, 1024, torch.float32),
    (512, 128, 2048, torch.float32),
    (100, 48, 1000, torch.float32),
    (300, 96, 5000, torch.bfloat16),
    (1, 32, 300, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,V,dtype", XENT_CASES)
def test_cuda_fused_xent_kernel_vs_plain(cuda_device, T, d, V, dtype):
    h, W, labels = xent_case(T, d, V)
    h, W = (torch.from_numpy(a).to(cuda_device, dtype) for a in (h, W))
    labels = torch.from_numpy(labels).to(cuda_device)
    fx = fused_xent.fused_softmax_xent_fwd
    before = fx.launches
    got = fx(h, W, labels)
    want = tref.softmax_xent(h, W, labels)
    torch.cuda.synchronize()
    assert fx.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# (T, d, V, dtype, tensor cores): each route of the cross-entropy.  bf16
# with d and V multiples of 8 takes the tensor cores (forward and the
# backward kernels); bf16 with a ragged V or d and float32 take the
# CUDA-core forward and recompute the backward through the plain version.
XENT_ROUTES = [
    (300, 96, 5000, torch.bfloat16, True),
    (150, 64, 704, torch.bfloat16, True),
    (1, 128, 1024, torch.bfloat16, True),
    (200, 64, 700, torch.bfloat16, False),
    (150, 36, 704, torch.bfloat16, False),
    (150, 32, 700, torch.float32, False),
]
#: the backward kernels' bound against the plain recompute, per leaf:
#: rtol 2^-7 (one bf16 ulp) and atol 2^-9 max|want|
XENT_BWD_RTOL, XENT_BWD_ATOL = 2.0 ** -7, 2.0 ** -9


def _close_per_leaf(got, want, rtol, atol_frac):
    atol = atol_frac * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,V,dtype,tc", XENT_ROUTES)
def test_cuda_fused_xent_routes(cuda_device, T, d, V, dtype, tc):
    """Forward (loss and lse) against the plain version, the op's backward
    against the plain recompute (the same leaves through ``ref.softmax_xent``
    under autograd), and the route's launch counters."""
    h, W, labels = xent_case(T, d, V)
    h, W = (torch.from_numpy(a).to(cuda_device, dtype) for a in (h, W))
    labels = torch.from_numpy(labels).to(cuda_device)
    g = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 1.5, T).astype(np.float32)).to(cuda_device)
    fx, bx = fused_xent.fused_softmax_xent_fwd, fused_xent.fused_softmax_xent_bwd
    counts = lambda: (fx.launches, fx.tensor_core_launches, bx.launches,
                      bx.tensor_core_launches)
    before = counts()
    assert fused_xent.tensor_core_route(h, W) == tc
    loss, lse = fused_xent.fused_softmax_xent_fwd_lse(h, W, labels)
    want_loss, want_lse = tref.softmax_xent_lse(h, W, labels)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    leaves = [t.clone().requires_grad_() for t in (h, W)]
    (tops.fused_softmax_xent(*leaves, labels) * g).sum().backward()
    want = tops._recompute_vjp(tref.softmax_xent, (h, W, labels), (g,))[:2]
    torch.cuda.synchronize()
    assert counts() == tuple(b + n for b, n in zip(
        before, (2, 2 * tc, tc, tc)))
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(leaf.grad, w, rtol=1e-4, atol=1e-4)
        else:
            _close_per_leaf(leaf.grad, w, XENT_BWD_RTOL, XENT_BWD_ATOL)
    if tc:      # and against the route's rounding model
        model = tref.softmax_xent_bwd_tc(h, W, labels, lse, g)
        for leaf, m in zip(leaves, model):
            _close_per_leaf(leaf.grad, m, XENT_BWD_RTOL, XENT_BWD_ATOL)
    else:
        with pytest.raises(ValueError, match="backward kernels take"):
            bx(h, W, labels, lse, g)


@pytest.mark.cuda
def test_cuda_training_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attention_case(1, 8, 8, 2, 1, 16))
    out, lse = flash_attention.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_bwd(
            q, k, v, out, lse, torch.ones_like(q).transpose(1, 2)
            .contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="lse"):
        flash_attention.flash_attention_bwd(q, k, v, out, lse[:, :1], q)
    h, W, labels = (torch.from_numpy(a).to(cuda_device)
                    for a in xent_case(8, 4, 10))
    with pytest.raises(TypeError):
        fused_xent.fused_softmax_xent_fwd(h, W.bfloat16(), labels)
    with pytest.raises(TypeError):
        fused_xent.fused_softmax_xent_fwd(h, W, labels.long())


def _grads_on(device, fn, arrays):
    ts = [torch.from_numpy(a).to(device).requires_grad_(
        a.dtype == np.float32) for a in arrays]
    fn(*ts).backward()
    return [t.grad.cpu() for t in ts if t.requires_grad]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["flash_attention", "selective_scan",
                                "fused_softmax_xent"])
def test_cuda_autograd_ops_match_the_cpu(cuda_device, op):
    """Each differentiable op's gradients on the card (forward kernel, then
    the backward kernel or the plain recompute) against the same op on the
    CPU, where it runs the plain versions."""
    if op == "flash_attention":
        arrays = attention_case(1, 200, 200, 4, 2, 64)
        fn = lambda q, k, v: (tops.flash_attention(q, k, v, True, 64)
                              ** 2).mean()
    elif op == "selective_scan":
        arrays = scan_case(1, 48, 64, 8)
        fn = lambda *a: (tops.selective_scan(*a)[0] ** 2).mean()
    else:
        arrays = xent_case(150, 32, 700)
        fn = lambda h, W, lab: tops.fused_softmax_xent(h, W, lab).mean()
    for got, want in zip(_grads_on(cuda_device, fn, arrays),
                         _grads_on("cpu", fn, arrays)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
