"""Port kernels: the plain PyTorch versions agree with the reference's
Pallas kernels (interpret mode, via ``repro.kernels.ops``) and its jnp
oracles (``repro.kernels.ref``) on the same numpy-made inputs.

Tolerances: the gather is pure data movement, so bitwise.  MCLR local SGD
sums in another order than the reference (batched matmuls, torch's
log_softmax), so it is held to the reference's own kernel-vs-XLA bound,
rtol = atol = 2e-5.

The hand-written CUDA kernels run only on the card: the tests marked
``cuda`` hold them against the plain versions there and skip elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, fed_gather, fed_local_sgd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 2e-5


def _gather_case():
    rng = np.random.default_rng(0)
    max_n, d, rows = 8, 5, 30
    flat = rng.normal(size=(rows + max_n, d)).astype(np.float32)
    flat_y = rng.integers(0, 4, rows + max_n).astype(np.int32)
    # interior, n == max_n, n == 0, a start past rows - max_n (clamped)
    starts = np.array([0, 4, 12, 20, 30, 35], np.int32)
    ns = np.array([4, 8, 0, 6, 0, 3], np.int32)
    return flat, flat_y, starts, ns, max_n


def test_gather_bitwise_vs_pallas_and_oracle():
    flat, flat_y, starts, ns, max_n = _gather_case()
    got = tops.fed_cohort_gather(torch.from_numpy(flat),
                                 torch.from_numpy(flat_y),
                                 torch.from_numpy(starts),
                                 torch.from_numpy(ns), max_n)
    ja = [jnp.asarray(a) for a in (flat, flat_y, starts, ns)]
    for want in (jops.fed_cohort_gather(*ja, max_n),
                 jref.fed_cohort_gather(*ja, max_n=max_n)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = got[2].numpy()
    assert mask[1].sum() == max_n and mask[2].sum() == 0


def test_gather_higher_rank_and_int_features():
    rng = np.random.default_rng(1)
    max_n = 4
    flat = rng.integers(0, 99, (10 + max_n, 3, 2)).astype(np.int32)
    flat_y = rng.integers(0, 2, 10 + max_n).astype(np.int32)
    starts, ns = np.array([0, 6], np.int32), np.array([4, 3], np.int32)
    x, y, mask = tops.fed_cohort_gather(
        torch.from_numpy(flat), torch.from_numpy(flat_y),
        torch.from_numpy(starts), torch.from_numpy(ns), max_n)
    xr, yr, mr = jops.fed_cohort_gather(
        jnp.asarray(flat), jnp.asarray(flat_y), jnp.asarray(starts),
        jnp.asarray(ns), max_n)
    assert tuple(x.shape) == (2, max_n, 3, 2) and x.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy(), np.asarray(xr))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yr))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mr))


def _sgd_case(seed=2, K=4, max_n=24, d=16, C=5, max_iters=12, B=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, max_n, d)).astype(np.float32)
    y = rng.integers(0, C, (K, max_n)).astype(np.int32)
    # full / n_k < B / empty / ragged
    ns = np.array([max_n, 3, 0, 17], np.int32)[:K]
    n_iters = np.array([max_iters, 7, 0, 5], np.int32)[:K]
    idx = (rng.random((K, max_iters, B))
           * np.maximum(ns, 1)[:, None, None]).astype(np.int32)
    w0 = (rng.normal(size=(d, C)) * 0.1).astype(np.float32)
    b0 = (rng.normal(size=C) * 0.1).astype(np.float32)
    return x, y, idx, w0, b0, ns, n_iters


@pytest.mark.parametrize("prox_mu", [0.0, 0.2])
def test_local_sgd_close_to_pallas_and_oracle(prox_mu):
    args = _sgd_case()
    got = tops.fed_local_sgd_mclr(*[torch.from_numpy(a) for a in args],
                                  lr=0.1, prox_mu=prox_mu)
    ja = [jnp.asarray(a) for a in args]
    for want in (jops.fed_local_sgd_mclr(*ja, lr=0.1, prox_mu=prox_mu),
                 jref.fed_local_sgd_mclr(*ja, lr=0.1, prox_mu=prox_mu)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TOL, atol=TOL)


def test_local_sgd_zero_budget_keeps_globals_and_zero_loss():
    x, y, idx, w0, b0, ns, _ = _sgd_case(seed=3)
    w, b, loss = tops.fed_local_sgd_mclr(
        *[torch.from_numpy(a) for a in (x, y, idx, w0, b0, ns)],
        torch.zeros(len(ns), dtype=torch.int32), lr=0.5)
    for k in range(len(ns)):
        np.testing.assert_array_equal(w[k].numpy(), w0)
        np.testing.assert_array_equal(b[k].numpy(), b0)
    np.testing.assert_array_equal(loss.numpy(), np.zeros(len(ns)))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    fed_gather.fed_cohort_gather.launches = 0
    fed_local_sgd.fed_local_sgd_mclr.launches = 0
    flat, flat_y, starts, ns, max_n = _gather_case()
    tops.fed_cohort_gather(torch.from_numpy(flat), torch.from_numpy(flat_y),
                           torch.from_numpy(starts), torch.from_numpy(ns),
                           max_n)
    tops.fed_local_sgd_mclr(*[torch.from_numpy(a) for a in _sgd_case()],
                            lr=0.1)
    assert fed_gather.fed_cohort_gather.launches == 0
    assert fed_local_sgd.fed_local_sgd_mclr.launches == 0


def test_nvcc_command_targets_sm_90a():
    for name in build.SIGNATURES:
        cmd = build.nvcc_command(name, "/tmp/out.so")
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
        assert {"-shared", "-O3"} <= set(cmd)
        assert cmd[-1].endswith(f"csrc/{name}.cu")
        assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    # a library is keyed by its source: both sources get distinct paths
    paths = {build.library_path(n) for n in build.SIGNATURES}
    assert len(paths) == len(build.SIGNATURES)


def test_shared_memory_budget_at_paper_shapes():
    # FEMNIST (d=784, C=26, B=10) and synthetic (d=60, C=10) both fit the
    # 227 KB a Hopper block may use
    assert fed_local_sgd.smem_bytes(784, 26, 10) <= fed_local_sgd.SMEM_LIMIT
    assert fed_local_sgd.smem_bytes(60, 10, 10) <= fed_local_sgd.SMEM_LIMIT
    assert fed_local_sgd.smem_bytes(4096, 26, 10) > fed_local_sgd.SMEM_LIMIT


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_gather_kernel_bitwise_vs_plain(cuda_device):
    flat, flat_y, starts, ns, max_n = _gather_case()
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
    t = [torch.from_numpy(a).to(cuda_device) for a in _sgd_case()]
    before = fed_local_sgd.fed_local_sgd_mclr.launches
    got = fed_local_sgd.fed_local_sgd_mclr(*t, 0.1, prox_mu)
    want = tref.fed_local_sgd_mclr(*t, lr=0.1, prox_mu=prox_mu)
    assert fed_local_sgd.fed_local_sgd_mclr.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
