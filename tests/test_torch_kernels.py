"""Port kernels: the plain PyTorch versions agree with the reference's
Pallas kernels (interpret mode, via ``repro.kernels.ops``) and its jnp
oracles (``repro.kernels.ref``) on the same numpy-made inputs.

Tolerances: the gather is pure data movement, so bitwise.  MCLR and
dense-MLP local SGD sum in another order than the reference (batched
matmuls, torch's log_softmax), so they are held to the reference's own
kernel-vs-XLA bound, rtol = atol = 2e-5, at a few iterations.  The
compressor is bitwise (tests/test_torch_compression.py holds the plain
version against the reference).

The hand-written CUDA kernels run only on the card: the tests marked
``cuda``, in tests/test_torch_cuda.py, hold them against the plain
versions there and skip elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import (build, fed_compress, fed_gather,
                                 fed_local_sgd, fed_local_sgd_dense)
from repro_torch.kernels import ops as tops
from torch_cases import dense_case, gather_case, sgd_case
from torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-5


def test_gather_bitwise_vs_pallas_and_oracle():
    flat, flat_y, starts, ns, max_n = gather_case()
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


@pytest.mark.parametrize("prox_mu", [0.0, 0.2])
def test_local_sgd_close_to_pallas_and_oracle(prox_mu):
    args = sgd_case()
    got = tops.fed_local_sgd_mclr(*[torch.from_numpy(a) for a in args],
                                  lr=0.1, prox_mu=prox_mu)
    ja = [jnp.asarray(a) for a in args]
    for want in (jops.fed_local_sgd_mclr(*ja, lr=0.1, prox_mu=prox_mu),
                 jref.fed_local_sgd_mclr(*ja, lr=0.1, prox_mu=prox_mu)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TOL, atol=TOL)


def test_local_sgd_zero_budget_keeps_globals_and_zero_loss():
    x, y, idx, w0, b0, ns, _ = sgd_case(seed=3)
    w, b, loss = tops.fed_local_sgd_mclr(
        *[torch.from_numpy(a) for a in (x, y, idx, w0, b0, ns)],
        torch.zeros(len(ns), dtype=torch.int32), lr=0.5)
    for k in range(len(ns)):
        np.testing.assert_array_equal(w[k].numpy(), w0)
        np.testing.assert_array_equal(b[k].numpy(), b0)
    np.testing.assert_array_equal(loss.numpy(), np.zeros(len(ns)))


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
@pytest.mark.parametrize("seed", [4, 5])
def test_dense_sgd_close_to_pallas_and_oracle(prox_mu, seed):
    args = dense_case(seed)
    got = tops.fed_local_sgd_dense(*[torch.from_numpy(a) for a in args],
                                   lr=0.1, prox_mu=prox_mu)
    ja = [jnp.asarray(a) for a in args]
    for want in (jops.fed_local_sgd_dense(*ja, lr=0.1, prox_mu=prox_mu),
                 jref.fed_local_sgd_dense(*ja, lr=0.1, prox_mu=prox_mu)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TOL, atol=TOL)
    # the zero-budget lane (3) keeps the globals bitwise and reports loss 0
    for g, init in zip(got[:4], args[3:7]):
        np.testing.assert_array_equal(g[3].numpy(), init)
    assert float(got[4][3]) == 0.0


def test_dense_sgd_zero_budget_keeps_globals_and_zero_loss():
    args = list(dense_case(6))
    args[-1] = np.zeros_like(args[-1])
    got = tops.fed_local_sgd_dense(*[torch.from_numpy(a) for a in args],
                                   lr=0.5, prox_mu=0.1)
    for g, init in zip(got[:4], args[3:7]):
        for k in range(len(args[-1])):
            np.testing.assert_array_equal(g[k].numpy(), init)
    np.testing.assert_array_equal(got[4].numpy(), np.zeros(len(args[-1])))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    wrappers = (fed_gather.fed_cohort_gather,
                fed_local_sgd.fed_local_sgd_mclr,
                fed_local_sgd_dense.fed_local_sgd_dense,
                fed_compress.fed_compress_topk_q8)
    for w in wrappers:
        w.launches = 0
    flat, flat_y, starts, ns, max_n = gather_case()
    tops.fed_cohort_gather(torch.from_numpy(flat), torch.from_numpy(flat_y),
                           torch.from_numpy(starts), torch.from_numpy(ns),
                           max_n)
    tops.fed_local_sgd_mclr(*[torch.from_numpy(a) for a in sgd_case()],
                            lr=0.1)
    tops.fed_local_sgd_dense(*[torch.from_numpy(a) for a in dense_case()],
                             lr=0.1)
    tops.fed_compress_topk_q8(torch.ones((2, 5)), 2)
    assert [w.launches for w in wrappers] == [0, 0, 0, 0]


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
    # one CTA of the cluster holds R rows of w (and w0 with prox) and its
    # slice of the batch rows: FEMNIST (d=784, C=26, B=10) fits a Hopper
    # block's 227 KB at every cluster size, the synthetic set (d=60, C=10)
    # at CS=1; d=1024 with prox only from CS=2; a wide d fits at no size
    m = fed_local_sgd
    limit = m.SMEM_LIMIT
    assert m.rows_per_cta(784, 8) == 100 and m.warps_per_cta(100, 10) == 13
    assert m.smem_bytes(784, 26, 10, 8, True) == 32448
    assert m.smem_bytes(784, 26, 10, 1, True) <= limit
    assert m.smem_bytes(1024, 26, 10, 1, True) > limit
    assert m.smem_bytes(1024, 26, 10, 2, True) <= limit
    assert m.smem_bytes(60, 10, 10, 1, True) <= limit
    assert m.smem_bytes(16384, 26, 10, 8, True) > limit
    with pytest.raises(ValueError, match="shared memory"):
        m.checked_cluster_size(10, 16384, 26, 10, True)


def test_dense_shared_memory_budget_at_paper_shapes():
    # w1's rows are split over the cluster, so the FEMNIST MLP (d=784,
    # H=64, C=26, B=10) fits from CS=2 (CS=4 with prox: w10 too) and the
    # synthetic one (d=60, C=10) at CS=1; a wide d fits at no size
    m = fed_local_sgd_dense
    limit = fed_local_sgd.SMEM_LIMIT
    assert m.smem_bytes(784, 64, 26, 10, 8, True) == 85344
    assert m.smem_bytes(784, 64, 26, 10, 1, False) > limit
    assert m.smem_bytes(784, 64, 26, 10, 2, False) <= limit
    assert m.smem_bytes(784, 64, 26, 10, 2, True) > limit
    assert m.smem_bytes(784, 64, 26, 10, 4, True) <= limit
    assert m.smem_bytes(60, 64, 10, 10, 1, True) <= limit
    assert m.smem_bytes(8192, 64, 26, 10, 8, True) > limit


def test_dense_wrapper_refuses_a_shape_over_the_budget():
    fed_local_sgd_dense.checked_cluster_size(10, 784, 64, 26, 10, True)
    with pytest.raises(ValueError, match="shared memory"):
        fed_local_sgd_dense.checked_cluster_size(10, 8192, 64, 26, 10, True)
    with pytest.raises(ValueError, match="shared memory"):
        fed_local_sgd_dense.checked_cluster_size(10, 784, 64, 26, 10, True,
                                                 cluster=2)
    with pytest.raises(ValueError, match="cluster"):
        fed_local_sgd_dense.checked_cluster_size(10, 784, 64, 26, 10, True,
                                                 cluster=3)


# (K, d, prox) -> the MCLR and the dense kernels' cluster sizes (C=26,
# H=64, B=10): 8 while K * 8 <= 132 SMs; smaller as K grows; the smallest
# size whose CTAs fit once no size keeps K * CS <= 132; 1 at the synthetic
# d=60 (fewer than 64 rows a CTA at CS=2)
CLUSTER_CHOICES = [
    (1, 784, False, 8, 8), (10, 784, True, 8, 8), (16, 784, False, 8, 8),
    (17, 784, False, 4, 4), (20, 784, True, 4, 4), (33, 784, True, 4, 4),
    (34, 784, False, 2, 2), (66, 784, True, 2, 4), (67, 784, False, 1, 2),
    (200, 784, True, 1, 4), (10, 60, True, 1, 1), (200, 60, False, 1, 1),
    (10, 128, False, 2, 2), (1, 5, True, 1, 1),
]


@pytest.mark.parametrize("K,d,prox,mclr,dense", CLUSTER_CHOICES)
def test_cluster_size_choice(K, d, prox, mclr, dense):
    C = 10 if d == 60 else 26
    assert fed_local_sgd.checked_cluster_size(K, d, C, 10, prox) == mclr
    assert fed_local_sgd_dense.checked_cluster_size(K, d, 64, C, 10,
                                                    prox) == dense


def test_rows_per_cta_cover_d_in_quads():
    for d in (1, 3, 5, 60, 61, 784, 785):
        for cs in fed_local_sgd.CLUSTER_SIZES:
            R = fed_local_sgd.rows_per_cta(d, cs)
            assert R % 4 == 0 and R * cs >= d and (R - 4) * cs < d
            nw = fed_local_sgd.warps_per_cta(R, 10)
            assert 10 <= nw <= fed_local_sgd.MAX_THREADS // 32


# the compressor's launch plan (``fed_compress.plan``), pure Python

PLAN_PS = [1, 3, 5, 7, 257, 1001, 4099, 20410, 51930, 398048, 398049,
           4194304]


@pytest.mark.parametrize("P", PLAN_PS)
def test_compress_slices_cover_the_row_in_rank_order(P):
    for cs in fed_compress.CLUSTER_SIZES:
        sl = fed_compress.slices(P, cs)
        S = fed_compress.slice_len(P, cs)
        assert len(sl) == cs and S % 4 == 0 and S * cs >= P
        assert sl[0][0] == 0 and sl[-1][1] == P
        for (lo, hi), (lo2, _) in zip(sl, sl[1:]):
            assert lo <= hi == lo2 and hi - lo <= S


@pytest.mark.parametrize("K", [1, 10, 20, 50, 200])
def test_compress_plan_stays_within_shared_memory(K):
    for P in PLAN_PS:
        pl = fed_compress.plan(K, P)
        assert pl.cs in fed_compress.CLUSTER_SIZES
        assert pl.smem <= fed_compress.SMEM_LIMIT
        assert pl.smem == fed_compress.smem_bytes(pl.slice,
                                                  pl.route == "resident")
        assert pl.slice == fed_compress.slice_len(P, pl.cs)
        if pl.route == "resident":
            assert pl.slice <= fed_compress.MAX_RESIDENT_SLICE


def test_compress_routes_switch_at_the_resident_limit():
    top = 8 * fed_compress.MAX_RESIDENT_SLICE
    assert top == 398_048
    assert fed_compress.plan(1, top).route == "resident"
    assert fed_compress.smem_bytes(fed_compress.MAX_RESIDENT_SLICE,
                                   True) <= fed_compress.SMEM_LIMIT
    assert fed_compress.smem_bytes(fed_compress.MAX_RESIDENT_SLICE + 4,
                                   True) > fed_compress.SMEM_LIMIT
    for P in (top + 1, 4_194_304, 2**31 - 1):
        pl = fed_compress.plan(2, P)
        assert (pl.route, pl.cs) == ("streamed", 8)
    # a forced size streams where its slice does not fit
    assert fed_compress.plan(10, 51_930, cluster=1).route == "streamed"
    assert fed_compress.plan(10, 51_930, cluster=2).route == "resident"
    assert fed_compress.plan(1, 257, route="streamed").route == "streamed"


# (K, P) -> cluster size: 8 at the FEMNIST rows while K x 8 <= 132 SMs
# (one CTA an SM), then 4, 2; the smallest size that fits its slice once
# none keeps K x size <= 132; fewer than MIN_SLICE coordinates a CTA: no
# more split
COMPRESS_CHOICES = [(1, 51_930, 8), (10, 51_930, 8), (16, 51_930, 8),
                    (17, 51_930, 4), (20, 51_930, 4), (33, 51_930, 4),
                    (34, 51_930, 2), (50, 51_930, 2), (67, 51_930, 2),
                    (10, 20_410, 8), (20, 20_410, 4), (200, 20_410, 1),
                    (10, 4_096, 2), (10, 4_088, 1), (4, 257, 1), (1, 1, 1)]


@pytest.mark.parametrize("K,P,cs", COMPRESS_CHOICES)
def test_compress_cluster_size_choice(K, P, cs):
    pl = fed_compress.plan(K, P)
    assert (pl.route, pl.cs) == ("resident", cs)


@pytest.mark.parametrize("kw,match", [
    (dict(cluster=3), "cluster size 3"),
    (dict(cluster=16), "cluster size 16"),
    (dict(route="sorted"), "route 'sorted'"),
    (dict(route="resident", P=1_000_000), "shared memory"),
    (dict(route="resident", cluster=1, P=60_000), "shared memory"),
    (dict(P=2**31), "int indices"),
])
def test_compress_impossible_plan_is_refused_by_name(kw, match):
    P = kw.pop("P", 51_930)
    with pytest.raises(ValueError, match=match):
        fed_compress.plan(10, P, **kw)
