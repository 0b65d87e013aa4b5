"""Port upload compression against the reference, on the same numpy-made
inputs.

Bitwise: the plain top-k + int8 compressor against the reference's jnp
oracle and its Pallas kernel (interpret mode), ``resolve_k`` and the wire
bytes, the flatten contract (sorted-key leaf order) and the whole upload
stage on the same trained stack, where the error-feedback identity
``transmitted + residual' == delta + residual`` is exact.

A compressed packed round trains the clients first, and the two packages'
trained deltas may differ in the last ulp (local SGD sums in another
order).  Where two coordinates sit that close at the top-k threshold, the
kept set flips, so the round is held set-wise: the per-row kept sets agree
on at least 99.9% of coordinates, residual and global agree within 2e-5
on the coordinates kept by both, each uploading row sends exactly
min(k, nnz) values and the identity is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core.aggregation import _flatten_clients as j_flatten_clients
from repro.core.engine import RoundEngine as JEngine
from repro.data.federated import make_femnist_like as jfemnist
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.fl_models import make_mclr as jmclr
from repro.models.fl_models import make_mlp as jmlp
from repro_torch.convert import params_from_reference, params_to_numpy
from repro_torch.core import compression as tcomp
from repro_torch.core.aggregation import _flatten_clients as t_flatten_clients
from repro_torch.core.aggregation import _unflatten_like as t_unflatten_like
from repro_torch.core.engine import RoundEngine as TEngine
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.kernels import ref as tref
from repro_torch.models.fl_models import make_mclr, make_mlp
from torch_cases import one_torch_thread  # noqa: F401

TOL = 2e-5


# ---------------------------------------------------------------------------
# the compressor
# ---------------------------------------------------------------------------


def _compress_case(kind, seed):
    rng = np.random.default_rng(seed)
    K, P = 4, 257                                    # an odd P
    if kind == "ties_spread":
        P = 4099                 # over a cluster of 8 slices at the card
    ef = rng.normal(size=(K, P)).astype(np.float32)
    k = 26
    if kind == "ties":           # many coordinates exactly at the threshold
        ef[0, rng.choice(P, 60, replace=False)] = np.float32(1.5)
        ef[1, rng.choice(P, 40, replace=False)] = np.float32(-1.5)
        ef[2, ::3] = np.float32(0.25)
        k = 40
    elif kind == "zero_row":
        ef[1] = 0.0
    elif kind == "negative_amax":  # |e| == amax on negative entries
        ef[:, 5] = -4.0
        ef[:, 77] = 4.0
        ef[3, 100] = -4.0
    elif kind == "k0":
        k = 0
    elif kind == "kP":
        k = P
    elif kind == "k1":
        k = 1
    elif kind == "kP-1":
        k = P - 1
    elif kind == "scaled":      # deltas of a trained round: tiny magnitudes
        ef *= np.float32(3e-4)
        ef[0, :50] = np.float32(1e-4)
        k = 60
    elif kind == "signed_zero":  # -0.0 and +0.0 tie at |e| == 0
        ef[:, ::2] = np.float32(-0.0)
        ef[:, 1::4] = np.float32(0.0)
        k = 100
    elif kind == "subnormal":    # subnormal entries, the threshold among
        ef[0, ::5] = np.float32(-2e-40)     # them in row 0: each quantises to
        ef[1, 3::7] = np.float32(1e-45)     # 0 (the reference's XLA CPU
        ef[2, 1::9] = np.float32(3e-39)     # backend compares them as zero)
        k = 220
    elif kind == "all_tied":     # one magnitude in every row, both signs
        ef[:] = np.float32(0.75)
        ef[:, ::3] = np.float32(-0.75)
        k = 100
    elif kind == "ties_spread":  # ties across the row, the cut in its middle
        ef *= np.float32(1e-3)
        ef[np.abs(ef) >= np.float32(2.5e-3)] = np.float32(1e-3)
        ef[:, 1500::11] = np.float32(2.5e-3)
        ef[1, 1500::22] = np.float32(-2.5e-3)
        ef[2, :3] = np.float32(4e-3)
        k = len(range(1500, 2800, 11))
    return ef, k


CASES = ["plain", "ties", "zero_row", "negative_amax", "k0", "kP", "k1",
         "kP-1", "scaled", "signed_zero", "subnormal", "all_tied",
         "ties_spread"]


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_compress_bitwise_vs_oracle_and_pallas(kind, seed):
    ef, k = _compress_case(kind, seed)
    q, scale = tref.fed_compress_topk_q8(torch.from_numpy(ef), k=k)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    for wq, ws in (jref.fed_compress_topk_q8(jnp.asarray(ef), k=k),
                   jops.fed_compress_topk_q8(jnp.asarray(ef), k)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(ws))
    nnz = (q.numpy() != 0).sum(1)
    if kind in ("ties", "plain", "all_tied", "ties_spread"):
        assert (nnz <= k).all() and nnz.max() == k
    if kind == "k0":
        assert nnz.sum() == 0
    if kind == "zero_row":
        assert nnz[1] == 0 and scale[1] == 0


def test_compress_takes_the_earliest_ties():
    ef = np.zeros((1, 9), np.float32)
    ef[0, [1, 3, 4, 6, 8]] = [2.0, 1.0, 1.0, 1.0, 1.0]   # thr = 1.0
    q, _ = tref.fed_compress_topk_q8(torch.from_numpy(ef), k=3)
    np.testing.assert_array_equal(np.nonzero(q.numpy()[0])[0], [1, 3, 4])


@pytest.mark.parametrize("frac", [0.0, 0.001, 0.05, 0.1, 0.33, 0.5, 1.0])
def test_resolve_k_and_upload_bytes_match_reference(frac):
    for P in (1, 7, 257, 20410, 51930):
        assert tcomp.resolve_k(frac, P) == jcomp.resolve_k(frac, P)
        for mode in tcomp.COMPRESS_MODES:
            assert (tcomp.upload_bytes_per_client(P, mode, frac)
                    == jcomp.upload_bytes_per_client(P, mode, frac))


def test_config_validation():
    with pytest.raises(ValueError, match="topk_frac"):
        tcomp.resolve_k(1.5, 10)
    with pytest.raises(ValueError, match="unknown upload_compress"):
        tcomp.check_compress("topk_q4")
    with pytest.raises(ValueError, match="unknown upload_compress"):
        TEngine(lr=0.1, compress="dense")


# ---------------------------------------------------------------------------
# flatten contract and the stage on a fixed trained stack
# ---------------------------------------------------------------------------


def _mlp_params(seed, K=None, d=12, H=8, C=5):
    rng = np.random.default_rng(seed)
    lead = () if K is None else (K,)
    return {"w1": rng.normal(size=lead + (d, H)).astype(np.float32),
            "b1": rng.normal(size=lead + (H,)).astype(np.float32),
            "w2": rng.normal(size=lead + (H, C)).astype(np.float32),
            "b2": rng.normal(size=lead + (C,)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_flatten_order_is_sorted_keys_and_round_trips():
    g, stack = _mlp_params(0), _mlp_params(1, K=3)
    got = tcomp.flatten_global(_t(g)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcomp.flatten_global(jax.tree.map(jnp.asarray, g))))
    # b1, b2, w1, w2: the sorted keys, not the insertion order
    np.testing.assert_array_equal(got[:8], g["b1"])
    np.testing.assert_array_equal(got[8:13], g["b2"])
    flat = t_flatten_clients(_t(stack)).numpy()
    np.testing.assert_array_equal(
        flat, np.asarray(j_flatten_clients(jax.tree.map(jnp.asarray,
                                                        stack))))
    back = tcomp.unflatten_rows(torch.from_numpy(flat), _t(g))
    for k in g:
        np.testing.assert_array_equal(back[k].numpy(), stack[k])
    one = t_unflatten_like(torch.from_numpy(got), _t(g))
    for k in g:
        np.testing.assert_array_equal(one[k].numpy(), g[k])
    assert tcomp.n_params_of(_t(g)) == jcomp.n_params_of(g) == flat.shape[1]


def _stage_case(seed, K=5):
    g = {k: v * np.float32(0.1) for k, v in _mlp_params(seed).items()}
    rng = np.random.default_rng(seed + 10)
    stack = {k: (v[None] + rng.normal(scale=0.01, size=(K,) + v.shape)
                 ).astype(np.float32) for k, v in g.items()}
    P = sum(v.size for v in g.values())
    residual = rng.normal(scale=0.003, size=(K, P)).astype(np.float32)
    residual[0] = 0.0
    uploaded = np.array([True, True, False, True, False])[:K]
    return g, stack, residual, uploaded


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.5, 1.0])
def test_stage_bitwise_vs_reference_and_identity_exact(frac):
    g, stack, residual, uploaded = _stage_case(3)
    P = residual.shape[1]
    k = tcomp.resolve_k(frac, P)
    rec, new_res, sent = tcomp.apply_upload_compress(
        _t(g), _t(stack), torch.from_numpy(residual),
        torch.from_numpy(uploaded), k)
    jrec, jres, jsent = jcomp.apply_upload_compress(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, stack),
        jnp.asarray(residual), jnp.asarray(uploaded), k, backend="xla")
    for key in g:
        np.testing.assert_array_equal(rec[key].numpy(),
                                      np.asarray(jrec[key]))
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(sent.numpy(), np.asarray(jsent))
    # the identity, exactly: transmitted + residual' == delta + residual
    delta = (t_flatten_clients(_t(stack))
             - tcomp.flatten_global(_t(g))[None]).numpy()
    up = uploaded[:, None]
    np.testing.assert_array_equal(
        np.where(up, sent.numpy() + new_res.numpy(), 0.0),
        np.where(up, delta + residual, 0.0))
    # non-uploaders: residual kept bitwise, nothing sent, params == global
    np.testing.assert_array_equal(new_res.numpy()[~uploaded],
                                  residual[~uploaded])
    assert not sent.numpy()[~uploaded].any()
    for key in g:
        for r in np.nonzero(~uploaded)[0]:
            np.testing.assert_array_equal(rec[key][r].numpy(), g[key])


# ---------------------------------------------------------------------------
# a compressed packed round, with the reference's draws injected
# ---------------------------------------------------------------------------

B, MAX_ITERS, LR, FRAC = 4, 8, 0.05, 0.1
DS_KW = dict(n_clients=12, total=300, dim=16, max_size=24)


@pytest.fixture(scope="module")
def fed():
    jds = jfemnist(**DS_KW)
    return dict(jds=jds, tds=tfemnist(**DS_KW), max_n=int(jds.sizes.max()),
                ids=np.array([0, 2, 4, 5, 9, 11]),
                n_iters=np.array([0, 1, 3, 8, 2, 7], np.int32),
                rng=jax.random.PRNGKey(3))


def _reference_round(c, jmodel, jparams, residual, monkeypatch, agg,
                     sampling):
    """The reference's compressed pallas round, run with jit disabled so
    that its compressor's inputs and outputs can be captured."""
    seen = {}
    inner = jcomp.compress_rows

    def capture(ef, k, backend):
        q, scale = inner(ef, k, backend)
        seen.update(ef=np.asarray(ef), q=np.asarray(q))
        return q, scale

    monkeypatch.setattr(jcomp, "compress_rows", capture)
    eng = JEngine(lr=LR, aggregator=agg, donate=False, compress="topk_q8",
                  topk_frac=FRAC)
    fn = eng.make_packed_round(jmodel, B, MAX_ITERS, c["max_n"],
                               sampling=sampling, backend="pallas")
    pk = c["jds"].packed(c["max_n"])
    with jax.disable_jit():
        p, losses, _, res = fn(jparams, pk.x, pk.y, pk.offsets, pk.lengths,
                               jnp.asarray(c["ids"], jnp.int32),
                               jnp.asarray(c["n_iters"]), c["rng"],
                               jnp.asarray(residual))
    return (jax.tree.map(np.asarray, p), np.asarray(losses), np.asarray(res),
            seen)


def _port_round(c, model, jparams, residual, monkeypatch, agg, sampling):
    seen = {}
    inner = tcomp.compress_rows

    def capture(ef, k):
        q, scale = inner(ef, k)
        seen.update(ef=ef.numpy().copy(), q=q.numpy().copy(),
                    scale=scale.numpy().copy())
        return q, scale

    monkeypatch.setattr(tcomp, "compress_rows", capture)
    n = np.minimum(c["jds"].sizes[c["ids"]], c["max_n"])
    keys = jax.random.split(c["rng"], len(c["ids"]))
    if sampling == "iid":
        draws = np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
            k, (MAX_ITERS, B), 0, jnp.maximum(nk, 1)))(keys,
                                                       jnp.asarray(n)))
    else:
        draws = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (c["max_n"],)))(keys))
    eng = TEngine(lr=LR, aggregator=agg, compress="topk_q8", topk_frac=FRAC)
    fn = eng.make_packed_round(model, B, MAX_ITERS, c["max_n"],
                               sampling=sampling)
    pk = c["tds"].packed(c["max_n"], device="cpu")
    res_in = torch.from_numpy(residual.copy())
    p, losses, _, res = fn(params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu"), pk.x, pk.y, pk.offsets,
        pk.lengths, torch.from_numpy(c["ids"]),
        torch.from_numpy(c["n_iters"]), draws=draws, residual=res_in)
    assert np.array_equal(res_in.numpy(), residual)   # input not written
    return params_to_numpy(p), losses.numpy(), res.numpy(), seen


@pytest.mark.parametrize("kind,sampling", [("mclr", "iid"), ("mlp", "iid"),
                                           ("mlp", "shuffle")])
@pytest.mark.parametrize("agg", ["fedavg", "fedprox"])
def test_compressed_round_matches_reference_setwise(fed, kind, sampling, agg,
                                                    monkeypatch):
    from repro.core import aggregation as jagg
    from repro_torch.core import aggregation as tagg
    d, C = 16, fed["tds"].n_classes
    jmodel = jmclr(d, C) if kind == "mclr" else jmlp(d, C, hidden=8)
    tmodel = make_mclr(d, C) if kind == "mclr" else make_mlp(d, C, hidden=8)
    jparams = jmodel.init(jax.random.PRNGKey(7))
    N = fed["jds"].n_clients
    P = sum(int(np.size(v)) for v in jax.tree.leaves(jparams))
    residual = np.random.default_rng(4).normal(
        scale=1e-3, size=(N, P)).astype(np.float32)
    jp, jl, jres, jseen = _reference_round(
        fed, jmodel, jparams, residual, monkeypatch, jagg.get_aggregator(agg),
        sampling)
    tp, tl, tres, tseen = _port_round(
        fed, tmodel, jparams, residual, monkeypatch, tagg.get_aggregator(agg),
        sampling)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)

    ids, up = fed["ids"], fed["n_iters"] > 0
    k = tcomp.resolve_k(FRAC, P)
    tkept, jkept = tseen["q"] != 0, jseen["q"] != 0
    assert (tkept == jkept)[up].mean() >= 0.999
    both = tkept & jkept
    np.testing.assert_allclose(tres[ids][both], jres[ids][both], rtol=TOL,
                               atol=TOL)
    # exactly min(k, nnz) values sent per uploading row
    nnz = (tseen["ef"] != 0).sum(1)
    np.testing.assert_array_equal(tkept.sum(1)[up],
                                  np.minimum(k, nnz)[up])
    # the identity, exactly, from the port's own stage values
    sent = tseen["q"].astype(np.float32) * tseen["scale"][:, None]
    np.testing.assert_array_equal((sent + tres[ids])[up], tseen["ef"][up])
    # zero-budget and unselected clients keep their residual bitwise
    keep = np.ones(N, bool)
    keep[ids[up]] = False
    np.testing.assert_array_equal(tres[keep], residual[keep])
    np.testing.assert_array_equal(jres[keep], residual[keep])
    # the global: within tolerance where every uploader kept the same set
    same = (tkept == jkept)[up].all(0)
    flat_t = tcomp.flatten_global(_t(tp)).numpy()
    flat_j = np.asarray(jcomp.flatten_global(jp))
    np.testing.assert_allclose(flat_t[same], flat_j[same], rtol=TOL,
                               atol=TOL)
