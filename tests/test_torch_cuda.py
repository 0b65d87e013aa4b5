"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Every test here is marked ``cuda`` and skips
without a card; the file imports neither JAX nor the reference, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the gather and the compressor are bitwise; MCLR local SGD
rtol = atol = 2e-5 (the reference's kernel-vs-XLA bound); dense-MLP local
SGD rtol 5e-4, atol 5e-5 (the reference's MLP pallas-vs-xla bound).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (fed_compress, fed_gather, fed_local_sgd,
                                 fed_local_sgd_dense)
from repro_torch.kernels import ref as tref
from torch_cases import dense_case, gather_case, sgd_case

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
