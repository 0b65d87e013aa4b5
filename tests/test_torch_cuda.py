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
tests/test_kernels.py).  The Sent140 LSTM's loss and gradients on the card
are held to the CPU's at 1e-5, the robust aggregators at 1e-6 (1e-5 for
the geometric median) with Krum's and Bulyan's chosen clients equal, and
two card runs of one LSTM round must give the same bits.  The packed round
with the float32 Llama smoke LM as every client's local step is held to
the CPU's at 1e-4 (cohorts, budgets and L/H bitwise), and its scan driver
(the lanes' passes captured in the graph) bitwise its host driver with
device rng.  A faulted
federation on the card is bitwise its crash twin and a killed and resumed
run bitwise the uninterrupted one; against the CPU with the same draws it
picks the same cohorts and budgets, params within 2e-5.  The scan driver's
CUDA-graph replays are bitwise the host driver's eager device rounds
(``rng_impl="device"``) with no host read inside a block, and a scan run
killed and resumed at a block boundary is bitwise the uninterrupted one.
The three differentiable ops' gradients on the card are held against the
same ops on the CPU (their plain versions) at 1e-4.  In bfloat16 the
flash kernels run on the tensor cores and are also held to their
rounding models (``ref.attention_lse_tc``, ``ref.flash_attention_bwd_tc``,
which round P and dS to bfloat16 where the kernels do) at rtol 2^-7 (one
bfloat16 ulp) and atol 4e-3.  The fused cross-entropy's bfloat16
tensor-core backward (dlogits split into bf16 hi + lo, each gradient
rounded once) is held per leaf to the plain recompute and to its rounding
model ``ref.softmax_xent_bwd_tc`` at rtol 2^-7 and atol 2^-9 max|want|.
The VLM and encoder-decoder smoke configs serve on the card as on the CPU
(the same tokens, logits within 1e-4), one flash launch an attention
layer of the prefill.  The dry-run's trace of a smoke step on the card
(``launch.steps.trace_step``: the kernels launch, each charged as one op)
charges exactly what its meta-device trace charges, and its launch
counters match the kernel charges.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (fed_compress, fed_gather, fed_local_sgd,
                                 fed_local_sgd_dense, flash_attention,
                                 fused_xent, selective_scan)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_cases import (COMPRESS_CASES, DRYRUN_CASES, FAULT_CFG, FAULT_DS, FAULT_PATHS,
                         ROBUST_CASES, attention_case, cluster_case,
                         compress_case, dense_case, fault_kwargs,
                         LM_CFG, gather_case, gather_lanes_case, iid_draws,
                         lm_fed_case, lstm_case, mclr_init, moe_case,
                         padded_round_case, pitched_xent_case,
                         robust_stack_case, scan_case, sgd_case, xent_case)

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


# (K, max_n, feat, features, misaligned): the 16-byte path at FEMNIST's
# row width, K = 64, int32 features, a base 4 bytes off 16-byte alignment
# (the 4-byte path), and Sent140's rows of 25 int32 tokens (a width not a
# multiple of 4: the 4-byte path)
GATHER_CASES = [
    (10, 400, 784, "float32", False),
    (64, 50, 784, "float32", False),
    (16, 40, 784, "int32", False),
    (16, 40, 784, "float32", True),
    (10, 300, 25, "int32", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("K,max_n,feat,features,misaligned", GATHER_CASES)
def test_cuda_gather_kernel_lanes_bitwise_vs_plain(cuda_device, K, max_n,
                                                   feat, features,
                                                   misaligned):
    flat, flat_y, starts, ns, max_n = gather_lanes_case(K, max_n, feat)
    if features == "int32":
        flat = flat.view(np.int32)
    x = torch.from_numpy(flat).to(cuda_device)
    if misaligned:
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:].view(x.shape)
        assert x.data_ptr() % 16 == 4
    t = [x] + [torch.from_numpy(a).to(cuda_device)
               for a in (flat_y, starts, ns)]
    got = fed_gather.fed_cohort_gather(*t, max_n)
    want = tref.fed_cohort_gather(*t, max_n=max_n)
    assert got[0].dtype == x.dtype
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


# The local-SGD kernels run one thread-block cluster per client.  Cases
# (K, d, C, B, H, max_iters, clusters, prox_mu): FEMNIST's width at the
# default cluster size; the same inputs at cluster sizes 1 and 8; d not a
# multiple of the cluster size or of 4 (the 4-byte copy path); d below the
# cluster size (CTAs with no rows); K = 1; K = 20 at size 8 (160 CTAs, more
# than 132: clusters in waves); B below and above the 10 batch rows the
# registers hold (B = 3, 20); C above 32 and H not a multiple of 32.
SGD_CLUSTER_CASES = [
    (4, 784, 26, 10, 64, 24, (None,), 0.1),
    (3, 200, 26, 10, 64, 24, (1, 8), 0.0),
    (3, 200, 26, 10, 64, 24, (1, 8), 0.1),
    (3, 61, 10, 10, 64, 16, (1, 8), 0.1),
    (3, 5, 10, 10, 64, 16, (1, 8), 0.1),
    (1, 784, 26, 10, 64, 24, (8,), 0.0),
    (20, 784, 26, 10, 64, 12, (8,), 0.1),
    (3, 120, 26, 3, 64, 16, (None,), 0.1),
    (3, 120, 26, 20, 64, 16, (None, 2), 0.1),
    (3, 96, 40, 10, 50, 16, (None, 1), 0.1),
]
SGD_LR = 0.03


def _sgd_run(kind, t, mu, cluster):
    if kind == "mclr":
        return fed_local_sgd.fed_local_sgd_mclr(*t, SGD_LR, mu,
                                                cluster=cluster)
    return fed_local_sgd_dense.fed_local_sgd_dense(*t, SGD_LR, mu,
                                                   cluster=cluster)


def _sgd_plain(kind, t, mu):
    plain = (tref.fed_local_sgd_mclr if kind == "mclr"
             else tref.fed_local_sgd_dense)
    return plain(*t, lr=SGD_LR, prox_mu=mu)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mclr", "dense"])
@pytest.mark.parametrize("K,d,C,B,H,max_iters,clusters,mu",
                         SGD_CLUSTER_CASES)
def test_cuda_sgd_cluster_kernels_vs_plain_and_repeatable(
        cuda_device, kind, K, d, C, B, H, max_iters, clusters, mu):
    args = cluster_case(K, d, C, B, max_iters, H=H if kind == "dense"
                        else None)
    t = [torch.from_numpy(a).to(cuda_device) for a in args]
    want = _sgd_plain(kind, t, mu)
    rtol, atol = (TOL, TOL) if kind == "mclr" else (5e-4, 5e-5)
    for cluster in clusters:
        got = _sgd_run(kind, t, mu, cluster)
        again = _sgd_run(kind, t, mu, cluster)
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)          # two launches, the same bits
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
        # the zero-budget lane keeps the globals bitwise, with loss 0
        if K > 1:
            for g, init in zip(got[:-1], t[3:-2]):
                assert torch.equal(g[1], init)
            assert float(got[-1][1]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mclr", "dense"])
def test_cuda_sgd_cluster_kernels_zero_budgets(cuda_device, kind):
    args = list(cluster_case(5, 784, 26, 10, 8,
                             H=64 if kind == "dense" else None))
    args[-1][:] = 0
    args[-2][:] = 0
    t = [torch.from_numpy(a).to(cuda_device) for a in args]
    got = _sgd_run(kind, t, 0.1, None)
    torch.cuda.synchronize()
    for g, init in zip(got[:-1], t[3:-2]):
        for k in range(5):
            assert torch.equal(g[k], init)
    assert torch.equal(got[-1], torch.zeros(5, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mclr", "dense"])
def test_cuda_sgd_cluster_refuses_a_size_that_does_not_fit(cuda_device,
                                                           kind):
    args = cluster_case(2, 1024, 26, 10, 4,
                        H=64 if kind == "dense" else None)
    t = [torch.from_numpy(a).to(cuda_device) for a in args]
    with pytest.raises(ValueError, match="cluster"):
        _sgd_run(kind, t, 0.1, 3)
    with pytest.raises(ValueError, match="shared memory"):
        _sgd_run(kind, t, 0.1, 1)      # CS=1 with prox does not fit d=1024


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(COMPRESS_CASES))
def test_cuda_compress_cluster_cases_bitwise_vs_plain(cuda_device, name):
    """The compressor's cluster kernel at each of its cases
    (``torch_cases.COMPRESS_CASES``), at every k of the case: bitwise the
    plain version, one launch a call; ``misaligned`` reads ef from a base
    4 bytes off 16-byte alignment (the 4-byte cp.async path); ``k20`` and
    ``k50`` force clusters of 8, more CTAs than the card's 132 SMs."""
    K, P, cluster, route = COMPRESS_CASES[name]
    ef, ks = compress_case(name)
    t = torch.from_numpy(ef).to(cuda_device)
    if name == "misaligned":
        base = torch.zeros(K * P + 1, device=cuda_device)
        t = base[1:].view(K, P)
        t.copy_(torch.from_numpy(ef))
        assert t.data_ptr() % 16 == 4
    plan = fed_compress.plan(K, P, cluster, route)
    if name == "streamed_row" or route == "streamed":
        assert plan.route == "streamed"
    elif name in ("k20", "k50"):
        assert plan.route == "resident" and K * plan.cs > 132
    else:
        assert plan.route == "resident"
    for k in ks:
        before = fed_compress.fed_compress_topk_q8.launches
        q, scale = fed_compress.fed_compress_topk_q8(t, k, cluster=cluster,
                                                     route=route)
        wq, ws = tref.fed_compress_topk_q8(t, k=k)
        assert fed_compress.fed_compress_topk_q8.launches == before + 1
        assert torch.equal(scale, ws), (name, k)
        assert torch.equal(q, wq), (name, k, int((q != wq).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_cuda_compress_two_launches_same_bits(cuda_device, route):
    ef, _ = compress_case("straddle")
    t = torch.from_numpy(ef).to(cuda_device)
    k = 1137
    a = fed_compress.fed_compress_topk_q8(t, k, route=route)
    b = fed_compress.fed_compress_topk_q8(t, k, route=route)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


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
    # granite-moe's heads (16 q / 8 kv, hd 64), kimi-k2's head dim (112),
    # the jamba smoke's windowed attention past its window
    (1, 512, 512, 16, 8, 64, True, 0, torch.bfloat16),
    (10, 24, 24, 16, 8, 64, True, 0, torch.bfloat16),  # its 24-token rows
    (1, 256, 256, 8, 2, 112, True, 0, torch.bfloat16),
    (2, 80, 80, 4, 2, 32, True, 64, torch.bfloat16),
    (1, 80, 80, 4, 2, 32, True, 64, torch.float32),
    # whisper's encoder: non-causal, 6/6 heads of 64 over its 1,500
    # frames, a length off the 64-row tile (the last k tile partial)
    (2, 1500, 1500, 6, 6, 64, False, 0, torch.bfloat16),
    (1, 1500, 1500, 6, 6, 64, False, 0, torch.float32),
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


# (B, S, d, N): whole 16-step chunks; S not a multiple of the chunk and d
# not of the 64-channel block; decode's S = 1 (from scan_case's nonzero
# h0) at a small and at Falcon's width; N not a multiple of the 4 lanes
# per channel (1, 3, 17) and N = 64; d % 4 != 0 (the 4-byte copies);
# S = 4,096 for error growth; B = 1 at Falcon's width
SCAN_CASES = [
    (1, 256, 128, 8),
    (2, 300, 200, 16),
    (4, 1, 256, 16),
    (4, 1, 8192, 16),
    (1, 64, 96, 64),
    (2, 40, 50, 3),
    (2, 37, 128, 1),
    (1, 33, 64, 17),
    (1, 4096, 256, 16),
    (1, 1024, 8192, 16),
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
def test_cuda_selective_scan_misaligned_base_vs_plain(cuda_device):
    """dt and x 4 bytes off 16-byte alignment (d % 4 == 0): the 4-byte
    copies; and the single-step count at S = 1."""
    arrays = scan_case(2, 50, 128, 16)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    for i in (0, 4):                                  # dt, x
        buf = torch.empty(t[i].numel() + 1, device=cuda_device)
        buf[1:].copy_(t[i].reshape(-1))
        t[i] = buf[1:].view(t[i].shape)
    ss = selective_scan.selective_scan_fwd
    y, hT = ss(*t)
    want_y, want_h = tref.selective_scan(*t)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hT, want_h, rtol=1e-4, atol=1e-4)
    before = ss.single_step_launches
    ss(*[a[:, :1].contiguous() if a.dim() == 3 and a.shape[1] == 50 else a
         for a in t])
    assert ss.single_step_launches == before + 1


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
    (256, 1024, 49155, torch.bfloat16),     # granite-moe's odd vocabulary
    (256, 384, 51865, torch.bfloat16),      # whisper-tiny's
    (256, 2048, 92553, torch.bfloat16),     # internvl2-2b's
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
    # an odd V in a contiguous W: rows not 16 bytes apart, CUDA cores
    (64, 1024, 49155, torch.bfloat16, False),
    (64, 384, 51865, torch.bfloat16, False),    # whisper-tiny's V
    (64, 2048, 92553, torch.bfloat16, False),   # internvl2-2b's V
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


# (T, d, V): odd vocabularies in a [d, ceil8(V)] buffer (the tensor-core
# route), granite-moe's, whisper-tiny's and internvl2-2b's among them
XENT_PITCHED = [
    (37, 64, 1003),
    (150, 96, 5001),
    (64, 1024, 49155),
    (64, 384, 51865),
    (300, 2048, 92553),
]


def _pitched_on(device, T, d, V, pitch):
    """(h, W, labels) bf16 on ``device``, W the [:, :V] view of a
    [d, pitch] buffer whose pad columns hold NaN."""
    h, _, buf, labels = pitched_xent_case(T, d, V, pitch)
    h = torch.from_numpy(h).to(device, torch.bfloat16)
    W = torch.from_numpy(buf).to(device, torch.bfloat16)[:, :V]
    return h, W, torch.from_numpy(labels).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,V", XENT_PITCHED)
def test_cuda_fused_xent_odd_vocabulary_on_the_tensor_cores(cuda_device, T,
                                                            d, V):
    """A pitched W of an odd vocabulary takes the tensor cores, forward and
    backward kernels (one launch each), against the plain versions: the
    loss and lse within 1e-4, dh and dW per leaf against the rounding
    model and the plain recompute; dW comes back [d, V], a view of a
    pitched buffer; no NaN from the pad reaches any output."""
    h, W, labels = _pitched_on(cuda_device, T, d, V, fused_xent.pitch(V))
    assert W.stride() == (fused_xent.pitch(V), 1)
    assert fused_xent.tensor_core_route(h, W)
    g = torch.from_numpy(np.random.default_rng(6).uniform(
        0.5, 1.5, T).astype(np.float32)).to(cuda_device)
    fx, bx = fused_xent.fused_softmax_xent_fwd, fused_xent.fused_softmax_xent_bwd
    counts = lambda: (fx.launches, fx.tensor_core_launches, bx.launches,
                      bx.tensor_core_launches)
    before = counts()
    loss, lse = fused_xent.fused_softmax_xent_fwd_lse(h, W, labels)
    dh, dW = bx(h, W, labels, lse, g)
    torch.cuda.synchronize()
    assert counts() == tuple(b + 1 for b in before)
    want_loss, want_lse = tref.softmax_xent_lse(h, W, labels)
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    assert tuple(dW.shape) == (d, V) and dW.dtype == torch.bfloat16
    assert dW.stride() == (fused_xent.pitch(V), 1)
    assert tuple(dh.shape) == (T, d) and dh.is_contiguous()
    assert bool(torch.isfinite(dh).all() and torch.isfinite(dW).all())
    model = tref.softmax_xent_bwd_tc(h, W, labels, lse, g)
    want = tops._recompute_vjp(tref.softmax_xent, (h, W, labels), (g,))[:2]
    for got, m, w in zip((dh, dW), model, want):
        _close_per_leaf(got, m, XENT_BWD_RTOL, XENT_BWD_ATOL)
        _close_per_leaf(got, w, XENT_BWD_RTOL, XENT_BWD_ATOL)
    # the op on the leaves: its backward the kernels too
    leaves = [h.clone().requires_grad_(), W.detach().requires_grad_()]
    (tops.fused_softmax_xent(*leaves, labels) * g).sum().backward()
    assert counts() == tuple(b + 2 for b in before)
    for leaf, m in zip(leaves, model):
        _close_per_leaf(leaf.grad, m, XENT_BWD_RTOL, XENT_BWD_ATOL)


@pytest.mark.cuda
def test_cuda_fused_xent_routes_w_by_its_pitch(cuda_device):
    """A W whose rows lie a multiple of 8 elements apart takes the tensor
    cores; one whose pitch is not (V + 3 here) takes the CUDA-core forward
    and the plain recompute as backward, with the same values; a W whose
    rows are not contiguous is refused."""
    T, d, V = 100, 64, 1003
    fx, bx = fused_xent.fused_softmax_xent_fwd, fused_xent.fused_softmax_xent_bwd
    h, W, labels = _pitched_on(cuda_device, T, d, V, V + 3)
    assert W.stride(0) % 8 and not fused_xent.tensor_core_route(h, W)
    assert fused_xent.tensor_core_route(h, fused_xent.pitched(W))
    counts = lambda: (fx.launches, fx.tensor_core_launches, bx.launches,
                      bx.tensor_core_launches)
    before = counts()
    loss, lse = fused_xent.fused_softmax_xent_fwd_lse(h, W, labels)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1,) + before[1:]
    want_loss, want_lse = tref.softmax_xent_lse(h, W, labels)
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="backward kernels take"):
        bx(h, W, labels, lse, torch.ones_like(lse))
    leaves = [h.clone().requires_grad_(), W.detach().requires_grad_()]
    tops.fused_softmax_xent(*leaves, labels).sum().backward()
    assert counts() == (before[0] + 2,) + before[1:]
    want = tops._recompute_vjp(tref.softmax_xent, (h, W, labels),
                               (torch.ones_like(lse),))[:2]
    for leaf, w in zip(leaves, want):
        _close_per_leaf(leaf.grad, w, XENT_BWD_RTOL, XENT_BWD_ATOL)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        fused_xent.fused_softmax_xent_fwd(h, fused_xent.pitched(W).T.T[:, ::2],
                                          labels)


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


LSTM_TOL = 1e-5       # float32 loss and gradients, card against the CPU


def _lstm_grads(device, params, batch):
    from torch.func import grad_and_value

    from repro_torch.models.fl_models import lstm_loss
    p = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    g, loss = grad_and_value(lstm_loss)(p, b)
    return {k: v.cpu() for k, v in g.items()}, loss.cpu()


@pytest.mark.cuda
def test_cuda_lstm_loss_and_grads_match_the_cpu(cuda_device):
    from repro_torch.device import resolve_device
    resolve_device("cuda")                  # TF32 off, as the port runs
    params, batch = lstm_case()
    g_card, l_card = _lstm_grads(cuda_device, params, batch)
    g_cpu, l_cpu = _lstm_grads("cpu", params, batch)
    torch.testing.assert_close(l_card, l_cpu, rtol=LSTM_TOL, atol=LSTM_TOL)
    assert set(g_card) == set(params)
    for k in params:
        torch.testing.assert_close(g_card[k], g_cpu[k], rtol=LSTM_TOL,
                                   atol=LSTM_TOL)


def _lstm_round(device, seed=0):
    """One shuffle round of the LSTM on a small Sent140 federation, with
    numpy-made init and draws: (params, losses) on the CPU."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.data.federated import make_sent140_like
    from repro_torch.models.fl_models import make_lstm

    ds = make_sent140_like(n_clients=20, total=600, vocab=260, max_size=60)
    max_n = int(ds.sizes.max())
    params, _ = lstm_case(vocab=260)
    pk = ds.packed(max_n, device=device)
    ids = np.array([0, 3, 7, 11, 19])
    n_iters = np.array([6, 0, 3, 6, 1], np.int32)
    draws = np.random.default_rng(seed).random(
        (len(ids), max_n)).astype(np.float32)
    fn = RoundEngine(lr=0.3).make_packed_round(make_lstm(260), 10, 6, max_n)
    p, losses, _ = fn({k: torch.from_numpy(v).to(device)
                       for k, v in params.items()}, pk.x, pk.y, pk.offsets,
                      pk.lengths, torch.from_numpy(ids).to(device),
                      torch.from_numpy(n_iters).to(device),
                      draws=torch.from_numpy(draws).to(device))
    return {k: v.cpu() for k, v in p.items()}, losses.cpu()


@pytest.mark.cuda
def test_cuda_lstm_round_repeats_bitwise(cuda_device):
    """Two card runs of one LSTM round give the same bits: the embedding's
    gradient (``F.embedding``'s dense backward under ``vmap``) sums in a
    fixed order on the card.  The round also agrees with the CPU's."""
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    first, again = _lstm_round(cuda_device), _lstm_round(cuda_device)
    for a, b in zip((*first[0].values(), first[1]),
                    (*again[0].values(), again[1])):
        assert torch.equal(a, b)
    cpu = _lstm_round("cpu")
    for k, v in cpu[0].items():
        torch.testing.assert_close(first[0][k], v, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(first[1], cpu[1], rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", ROBUST_CASES)
def test_cuda_robust_aggregators_match_the_cpu(cuda_device, name, kw):
    """Each aggregator on the card against the CPU on a [10, 56,962] stack
    (the LSTM's P) with an adversarial row and a dropped client, under
    ``set_sync_debug_mode("error")``: a read back to the host fails."""
    from repro_torch.core import aggregation as tagg
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    stack, glob, w = robust_stack_case()
    agg = tagg.get_aggregator(name, **kw)
    args = [({k: torch.from_numpy(v).to(dev) for k, v in stack.items()},
             {k: torch.from_numpy(v).to(dev) for k, v in glob.items()},
             torch.from_numpy(w).to(dev))
            for dev in (cuda_device, "cpu")]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = agg(*args[0])
        chosen = (agg.select(tagg._flatten_clients(args[0][0]), args[0][2])
                  if hasattr(agg, "select") else None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = agg(*args[1])
    tol = 1e-5 if name == "geometric_median" else 1e-6
    for k in glob:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=tol, atol=tol)
    assert got["a"].abs().max() < 10         # the far-out row is kept out
    if chosen is not None:
        cpu = agg.select(tagg._flatten_clients(args[1][0]), args[1][2])
        assert torch.equal(chosen.cpu(), cpu)


def _fault_server(device, path, corrupt, rounds=5, draws=False, **over):
    """A FedSAEServer on ``device`` over the small faulted federation of
    ``torch_cases``; with ``draws`` (MCLR only) its init and minibatch
    draws come from numpy, the same on the card and on the CPU."""
    from repro_torch.core.server import FedSAEServer, ServerConfig
    from repro_torch.data.federated import make_femnist_like
    from repro_torch.faults import FaultModel

    fkw = fault_kwargs(corrupt)
    ds = make_femnist_like(**FAULT_DS)
    cfg = ServerConfig(device=str(device), rounds=rounds,
                       faults=None if fkw is None else FaultModel(**fkw),
                       **FAULT_CFG, **FAULT_PATHS[path], **over)
    srv = FedSAEServer(ds, cfg=cfg, init_params=mclr_init() if draws
                       else None)
    if draws:
        srv.data_draws = iid_draws(srv.max_iters, cfg.batch_size)
    return srv


def _assert_servers_bitwise(a, b):
    assert len(a.cohorts) == len(b.cohorts)
    for c1, c2 in zip(a.cohorts, b.cohorts):
        assert np.array_equal(c1, c2)
    for name in ("L", "H", "theta"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    assert np.array_equal(a.values.v, b.values.v)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    if a.residual is not None:
        assert torch.equal(a.residual, b.residual)


@pytest.mark.cuda
@pytest.mark.parametrize("path,mode", [
    ("mclr-iid", "nan"), ("mclr-iid", "inf"), ("mclr-iid", "explode"),
    ("mlp-topk_q8", "explode"), ("mlp-topk_q8", "nan")])
def test_cuda_crash_twin_bitwise(cuda_device, path, mode):
    """A screened run on the card is bitwise its crash twin (params,
    history, cohorts, residual), through the gather, the SGD kernel and,
    compressed, the compressor."""
    sgd = (fed_local_sgd_dense.fed_local_sgd_dense if path == "mlp-topk_q8"
           else fed_local_sgd.fed_local_sgd_mclr)
    before = (fed_gather.fed_cohort_gather.launches, sgd.launches,
              fed_compress.fed_compress_topk_q8.launches)
    twin = _fault_server(cuda_device, path, "crash")
    twin.run()
    faulted = _fault_server(cuda_device, path, mode)
    faulted.run()
    after = (fed_gather.fed_cohort_gather.launches, sgd.launches,
             fed_compress.fed_compress_topk_q8.launches)
    assert after[0] - before[0] == 10 and after[1] - before[1] == 10
    assert after[2] - before[2] == (10 if path == "mlp-topk_q8" else 0)
    assert sum(r.screened for r in faulted._records.records) > 0
    assert all(torch.isfinite(v).all() for v in faulted.params.values())
    _assert_servers_bitwise(twin, faulted)


@pytest.mark.cuda
def test_cuda_faulted_run_matches_the_cpu(cuda_device):
    """The same faulted federation with the same numpy draws on the card
    and on the CPU: cohorts, L/H and screened counts equal, params within
    2e-5."""
    runs = [_fault_server(dev, "mclr-iid", "nan", rounds=4, draws=True)
            for dev in (cuda_device, "cpu")]
    for srv in runs:
        srv.run()
    card, cpu = runs
    for c1, c2 in zip(card.cohorts, cpu.cohorts):
        assert np.array_equal(c1, c2)
    assert np.array_equal(card.L, cpu.L) and np.array_equal(card.H, cpu.H)
    assert ([r.screened for r in card._records.records]
            == [r.screened for r in cpu._records.records])
    for k in cpu.params:
        torch.testing.assert_close(card.params[k].cpu(), cpu.params[k],
                                   rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_cuda_kill_and_resume_bitwise(cuda_device, tmp_path):
    """4 rounds straight against 2, a checkpoint, a fresh server restored
    (the CUDA generator's state included) and 2 more: bitwise."""
    full = _fault_server(cuda_device, "mlp-topk_q8", "nan", rounds=4)
    full.run()
    d = str(tmp_path / "ck")
    _fault_server(cuda_device, "mlp-topk_q8", "nan", rounds=4).run(
        rounds=2, checkpoint_dir=d)
    resumed = _fault_server(cuda_device, "mlp-topk_q8", "nan", rounds=4)
    resumed.run(checkpoint_dir=d, resume=True)
    _assert_servers_bitwise(full, resumed)
    assert torch.equal(full.data_gen.get_state(),
                       resumed.data_gen.get_state())


def _scan_pair(device, path, corrupt=None, rounds=7, block=3, **over):
    """The host driver with ``rng_impl="device"`` and the scan driver over
    the same small federation, both run."""
    host = _fault_server(device, path, corrupt, rounds=rounds,
                         driver="host", rng_impl="device", block_size=block,
                         **over)
    scan = _fault_server(device, path, corrupt, rounds=rounds,
                         driver="scan", block_size=block, **over)
    host.run()
    scan.run()
    return host, scan


def _assert_scan_bitwise(host, scan):
    _assert_servers_bitwise(host, scan)
    for b1, b2 in zip(host.budgets, scan.budgets):
        assert np.array_equal(b1, b2)
    for name in ("q_fail", "q_try", "q_susp"):
        assert np.array_equal(getattr(host, name), getattr(scan, name))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["mclr-iid", "mlp-topk_q8"])
def test_cuda_scan_matches_host_device_rng(cuda_device, path):
    """The scan driver's graph replays are bitwise the host driver's eager
    device rounds over 3 blocks (3, 3 and a short 1): every replay draws
    the next Philox offsets of the registered generators, so the cohorts
    differ round to round and equal the eager run's; one stats pull and
    one eval a block."""
    host, scan = _scan_pair(cuda_device, path)
    _assert_scan_bitwise(host, scan)
    assert scan.program.graphed and scan.program.replays == 7
    assert scan.host_syncs == 3 + 3
    assert len({tuple(c) for c in scan.cohorts}) > 1
    assert torch.equal(host.sel_gen.get_state(), scan.sel_gen.get_state())
    assert torch.equal(host.data_gen.get_state(), scan.data_gen.get_state())


@pytest.mark.cuda
def test_cuda_scan_block_reads_nothing_on_the_host(cuda_device):
    """A block of replays runs under ``set_sync_debug_mode("error")``
    (``core.graphs.sync_checked``), which raises on any host read: the
    faulted, screened, quarantining scan run passes through it, bitwise
    its host twin, and the guard is live."""
    from repro_torch.core.graphs import sync_checked
    host, scan = _scan_pair(cuda_device, "mclr-iid", "nan",
                            quarantine_threshold=0.3,
                            quarantine_min_tries=1)
    _assert_scan_bitwise(host, scan)
    assert max(r.quarantined for r in scan._records.records) > 0
    with pytest.raises(RuntimeError, match="synchroniz"):
        with sync_checked(cuda_device):
            torch.ones(1, device=cuda_device).sum().item()


@pytest.mark.cuda
def test_cuda_scan_kill_and_resume_bitwise(cuda_device, tmp_path):
    """6 scan rounds in blocks of 3 against 3, a checkpoint at the block
    boundary, a fresh server restored (both generators' states included)
    and 3 more: bitwise."""
    kw = dict(driver="scan", block_size=3)
    full = _fault_server(cuda_device, "mlp-topk_q8", "nan", rounds=6, **kw)
    full.run()
    d = str(tmp_path / "ck")
    _fault_server(cuda_device, "mlp-topk_q8", "nan", rounds=6, **kw).run(
        rounds=3, checkpoint_dir=d)
    resumed = _fault_server(cuda_device, "mlp-topk_q8", "nan", rounds=6,
                            **kw)
    resumed.run(checkpoint_dir=d, resume=True)
    _assert_scan_bitwise(full, resumed)
    assert torch.equal(full.sel_gen.get_state(), resumed.sel_gen.get_state())
    assert torch.equal(full.data_gen.get_state(),
                       resumed.data_gen.get_state())


# ---------------------------------------------------------------------------
# an architecture id as the packed round's local step
# ---------------------------------------------------------------------------

LM_TOL = 1e-4


def _lm_server(device, rounds=2, dtype="float32", arch="llama3.2-3b",
               **over):
    from repro_torch.core.server import FedSAEServer, ServerConfig
    ds, step, init = lm_fed_case(arch=arch, dtype=dtype)
    cfg = ServerConfig(device=str(device), rounds=rounds,
                       **dict(LM_CFG, **over))
    kw = {} if over.get("driver") == "scan" or over.get("rng_impl") else \
        dict(data_draws=iid_draws(6, LM_CFG["batch_size"]))
    return FedSAEServer(ds, model=step, cfg=cfg, init_params=init, **kw)


@pytest.mark.cuda
def test_cuda_lm_round_matches_the_cpu(cuda_device):
    """Two host rounds of the float32 Llama smoke LM, lanes in turn, on the
    card and on the CPU from the same init and draws: the same cohorts,
    budgets and L/H; params and losses within 1e-4."""
    from repro_torch.tree import tree_leaves
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        srv = _lm_server(device)
        assert srv.max_iters == 6
        runs.append((srv, srv.run()))
    (card, hc), (cpu, hp) = runs
    for a, b in zip(card.cohorts, cpu.cohorts):
        assert np.array_equal(a, b)
    for a, b in zip(card.budgets, cpu.budgets):
        assert np.array_equal(a, b)
    assert np.array_equal(card.L, cpu.L) and np.array_equal(card.H, cpu.H)
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=LM_TOL, atol=LM_TOL)
    np.testing.assert_allclose(hc["train_loss"], hp["train_loss"],
                               rtol=LM_TOL, atol=LM_TOL)


@pytest.mark.cuda
def test_cuda_lm_scan_matches_host_device_rng(cuda_device):
    """The bf16 Llama smoke LM on the scan driver: one captured round (the
    three lanes' six forward and backward passes each, flash and
    cross-entropy kernels inside the graph) replayed a round, bitwise the
    host driver's eager device rounds."""
    from repro_torch.tree import tree_leaves
    host = _lm_server(cuda_device, rounds=4, dtype="bfloat16",
                      rng_impl="device", block_size=2)
    scan = _lm_server(cuda_device, rounds=4, dtype="bfloat16",
                      driver="scan", block_size=2)
    host.run()
    scan.run()
    for a, b in zip(host.cohorts, scan.cohorts):
        assert np.array_equal(a, b)
    for a, b in zip(host.budgets, scan.budgets):
        assert np.array_equal(a, b)
    for a, b in zip(tree_leaves(host.params), tree_leaves(scan.params)):
        assert torch.equal(a, b)
    assert scan.program.graphed and scan.program.replays == 4
    assert scan.program.per_replay["flash_attention_bwd"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_cuda_moe_and_hybrid_scan_match_host_device_rng(cuda_device, arch):
    """A MoE smoke LM and the jamba hybrid (bf16) on the scan driver: the
    routing, dispatch and combine inside the captured graph (no host
    read), bitwise the host driver's eager device rounds."""
    from repro_torch.tree import tree_leaves
    runs = [_lm_server(cuda_device, rounds=4, dtype="bfloat16", arch=arch,
                       block_size=2, **kw)
            for kw in (dict(rng_impl="device"), dict(driver="scan"))]
    for srv in runs:
        srv.run()
    host, scan = runs
    for a, b in zip(host.cohorts, scan.cohorts):
        assert np.array_equal(a, b)
    for a, b in zip(host.budgets, scan.budgets):
        assert np.array_equal(a, b)
    for a, b in zip(tree_leaves(host.params), tree_leaves(scan.params)):
        assert torch.equal(a, b)
    assert scan.program.graphed and scan.program.replays == 4


# ---------------------------------------------------------------------------
# the padded seed round and the MoE FFN
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("model,sampling", [("mclr", "iid"), ("mlp", "iid"),
                                            ("mclr", "shuffle")])
def test_cuda_padded_round_matches_the_cpu(cuda_device, model, sampling):
    """``make_round_fn`` on the card and on the CPU from the same init,
    stacked clients and draws: params and losses within 2e-5; the iid
    MCLR and MLP steps launch their fused kernels (one launch a round)."""
    from repro_torch.convert import params_from_reference, params_to_numpy
    from repro_torch.core.rounds import make_round_fn
    from repro_torch.models.fl_models import make_mclr, make_mlp
    ds, (x, y, mask, n, n_iters), draws = padded_round_case(sampling)
    step = (make_mclr if model == "mclr" else make_mlp)(64, ds.n_classes)
    init = params_to_numpy(step.init_params(torch.Generator().manual_seed(1)))
    kernel = {"mclr": fed_local_sgd.fed_local_sgd_mclr,
              "mlp": fed_local_sgd_dense.fed_local_sgd_dense}[model]
    outs = []
    for device in (cuda_device, torch.device("cpu")):
        fn = make_round_fn(step, 0.05, 4, 40, sampling=sampling)
        before = kernel.launches
        p, losses, up = fn(params_from_reference(init, device), x, y, mask,
                           n, n_iters, draws=draws)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert kernel.launches == before + (sampling == "iid")
        outs.append((p, losses, bool(up)))
    (pc, lc, uc), (pp, lp, up) = outs
    for k in pp:
        torch.testing.assert_close(pc[k].cpu(), pp[k], rtol=TOL, atol=TOL)
    torch.testing.assert_close(lc.cpu(), lp, rtol=TOL, atol=TOL)
    assert uc == up


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,S", [("float32", 48), ("bfloat16", 48),
                                     ("float32", 1)])
def test_cuda_moe_forward_matches_the_cpu(cuda_device, dtype, S):
    """``moe_forward`` on the card against the CPU on the same params and
    inputs: in float32 the same routing (expert ids and slots) and out
    within 1e-5 of its scale, aux within 1e-5, gradients within 1e-4; in
    bfloat16 out within 2e-2.  Forced overflow (capacity factor 0.25)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m", smoke=True).replace(
        dtype=dtype, capacity_factor=0.25)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x, cot = (torch.from_numpy(a) for a in moe_case(S))
    x = x.to(cfg.compute_dtype)
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        p = {k: v.to(device).requires_grad_() for k, v in params.items()}
        xd = x.to(device).requires_grad_()
        _, eidx, _ = moe.route(p, cfg, xd)
        dest, keep = moe.assign(eidx, cfg.n_experts,
                                moe.moe_capacity(cfg, S))
        out, aux = moe.moe_forward(p, cfg, xd)
        (torch.sum(out.float() * cot.to(device)) + aux).backward()
        runs.append([t.detach().cpu() for t in (eidx, dest, keep, out, aux,
                                                xd.grad)]
                    + [p[k].grad.cpu() for k in sorted(p)])
    card, cpu = runs
    if dtype == "float32":
        for a, b in zip(card[:3], cpu[:3]):
            assert torch.equal(a, b)
        scale = max(1.0, float(cpu[3].abs().max()))
        torch.testing.assert_close(card[3], cpu[3], rtol=1e-5,
                                   atol=1e-5 * scale)
        torch.testing.assert_close(card[4], cpu[4], rtol=1e-5, atol=1e-5)
        for a, b in zip(card[5:], cpu[5:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(card[3].float(), cpu[3].float(),
                                   rtol=2e-2, atol=2e-2)
    if S > 1:
        assert not bool(cpu[2].all())


@pytest.mark.cuda
def test_cuda_hybrid_serves_past_its_window_like_the_cpu(cuda_device):
    """The jamba smoke (float32) prefills 80 positions, past its 64-slot
    window, then decodes 4 greedy tokens into the ring buffer, on the card
    and on the CPU from the same params: the same tokens, logits within
    1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference, params_to_numpy
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    cfg = get_config("jamba-1.5-large-398b", smoke=True).replace(
        dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    runs = []
    for p, device in ((params_from_reference(params_to_numpy(params),
                                             cuda_device), cuda_device),
                      (params, torch.device("cpu"))):
        batch = serve.prompt_batch(cfg, 2, cfg.window_size + 16, device)
        runs.append(serve.generate(model, p, batch, 4))
    (tok_card, lg_card, _), (tok_cpu, lg_cpu, _) = runs
    assert torch.equal(tok_card.cpu(), tok_cpu)
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,prompt", [("internvl2-2b", 40),
                                         ("whisper-tiny", 48)])
def test_cuda_vlm_and_encdec_serve_like_the_cpu(cuda_device, arch, prompt):
    """The VLM smoke (16 of the prompt's positions patches) and the
    encoder-decoder smoke (48 frames, 32 decoder tokens), float32, served
    4 greedy tokens on the card and on the CPU from the same params and
    the serve driver's batch: the same tokens, logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_reference, params_to_numpy
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    fa = flash_attention.flash_attention_fwd
    runs = []
    for p, device in ((params_from_reference(params_to_numpy(params),
                                             cuda_device), cuda_device),
                      (params, torch.device("cpu"))):
        before = fa.launches
        batch = serve.prompt_batch(cfg, 2, prompt, device)
        runs.append(serve.generate(model, p, batch, 4))
        if device.type == "cuda":     # one launch an attention layer
            assert fa.launches - before == cfg.n_layers + (
                cfg.n_encoder_layers if cfg.is_encoder_decoder else 0)
    (tok_card, lg_card, _), (tok_cpu, lg_cpu, _) = runs
    assert torch.equal(tok_card.cpu(), tok_cpu)
    torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_warm_profile_keeps_a_device_record_of_every_launch(
        cuda_device, tmp_path):
    """``obs.warm_profile`` opens its window after its warm-up launches: the
    trace holds the block's 40 launches, each with its kernel record (the
    same correlation id), and none of the warm-up's."""
    import json

    from repro_torch.obs import warm_profile
    x = torch.zeros(1 << 16, device=cuda_device)
    torch.cuda.synchronize()
    with warm_profile() as prof:
        for _ in range(40):
            x.mul_(1.5)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    calls = {e["args"]["correlation"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "aunch" in e["name"]}
    kernels = [e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel"]
    assert len(calls) == 40
    assert sorted(kernels) == sorted(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind,S,B", DRYRUN_CASES)
def test_cuda_trace_step_equals_meta(cuda_device, arch, kind, S, B):
    """The dry-run's trace of a smoke step on the card (the kernels
    launch, each charged as one op; a backward's kernels from the
    autograd engine's device thread) charges what the meta-device trace
    charges (the kernels' output shapes alone), op by op, and a train
    step's launch counters show its flash and cross-entropy kernels."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import trace_step
    from repro_torch.models.api import build_model
    one = AbstractMesh((1, 1), ("data", "model"))
    model = build_model(get_config(arch, smoke=True))
    shape = ShapeConfig("t", S, B, kind)
    meta, _, _ = trace_step(model, shape, one)
    counted = (flash_attention.flash_attention_fwd,
               flash_attention.flash_attention_bwd,
               fused_xent.fused_softmax_xent_fwd,
               fused_xent.fused_softmax_xent_bwd,
               selective_scan.selective_scan_fwd)
    before = [fn.launches for fn in counted]
    card, _, _ = trace_step(model, shape, one, device=cuda_device)
    torch.cuda.synchronize()
    launched = [fn.launches - b for fn, b in zip(counted, before)]
    costly = lambda c: {k: v for k, v in c.by_op.items() if v[1] or v[2]}
    assert costly(card) == costly(meta)
    assert card.flops == meta.flops
    assert card.bytes_accessed == meta.bytes_accessed
    kernels = {k[7:]: v[0] for k, v in card.by_op.items()
               if k.startswith("kernel.")}
    for fn, n in zip(counted, launched):
        assert n == kernels.get(fn.__name__, 0), fn.__name__
    if kind == "train" and arch != "falcon-mamba-7b":
        assert all(n > 0 for n in launched[:4]), launched
