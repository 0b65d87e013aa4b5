"""Seeded numpy inputs shared by the port's kernel tests (the CPU parity
tests in test_torch_kernels.py and the card tests in test_torch_cuda.py),
and the one-thread module fixture of the port's CPU test files.  Imports
neither JAX nor the reference, so the card tests run where JAX is not
installed."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread (import this fixture into the
    module).  The port's CPU tests run many small ops (an LSTM walks its 25
    tokens as hundreds of tiny ops a step, the plain SGD loops one Python
    iteration per local step); with the default intra-op pool every op
    wakes a thread per core, and beside the suite's other workers (``-n
    6``) those threads contend for the cores: on an 8-core host one LSTM
    host round took ~110 s instead of ~6 s beside one other torch process,
    and a file of host rounds ran 20x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gather_case():
    rng = np.random.default_rng(0)
    max_n, d, rows = 8, 5, 30
    flat = rng.normal(size=(rows + max_n, d)).astype(np.float32)
    flat_y = rng.integers(0, 4, rows + max_n).astype(np.int32)
    # interior, n == max_n, n == 0, a start past rows - max_n (clamped)
    starts = np.array([0, 4, 12, 20, 30, 35], np.int32)
    ns = np.array([4, 8, 0, 6, 0, 3], np.int32)
    return flat, flat_y, starts, ns, max_n


def gather_lanes_case(K, max_n, feat, seed=0):
    """A federation of 3 * max_n rows of ``feat`` features and K lanes:
    random starts (one past rows - max_n, clamped) and lengths (one 0, one
    max_n)."""
    rng = np.random.default_rng(seed)
    rows = 3 * max_n
    flat = rng.normal(size=(rows, feat)).astype(np.float32)
    flat_y = rng.integers(0, 26, rows).astype(np.int32)
    starts = rng.integers(0, rows - max_n + 1, K).astype(np.int32)
    starts[-1] = rows - 3                  # past rows - max_n: clamped
    ns = rng.integers(0, max_n + 1, K).astype(np.int32)
    ns[0], ns[1] = 0, max_n
    return flat, flat_y, starts, ns, max_n


def sgd_case(seed=2, K=4, max_n=24, d=16, C=5, max_iters=12, B=4):
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


def dense_case(seed=4, K=5, max_n=20, d=24, H=12, C=5, max_iters=8, B=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, max_n, d)).astype(np.float32)
    y = rng.integers(0, C, (K, max_n)).astype(np.int32)
    # full / n_k < B / empty / ragged / ragged
    ns = np.array([max_n, 3, 0, 13, 7], np.int32)[:K]
    n_iters = np.array([max_iters, 5, 3, 0, 6], np.int32)[:K]
    idx = (rng.random((K, max_iters, B))
           * np.maximum(ns, 1)[:, None, None]).astype(np.int32)
    w1 = (rng.normal(size=(d, H)) * d ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=H) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(H, C)) * H ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=C) * 0.1).astype(np.float32)
    return x, y, idx, w1, b1, w2, b2, ns, n_iters


def cluster_case(K, d, C, B, max_iters, H=None, max_n=40, seed=11):
    """Inputs of the local-SGD kernels at a chosen width: x [K, max_n, d]
    (0.2 N(0, 1)), labels, idx [K, max_iters, B], the global params (MCLR
    (w0, b0), or the MLP's (w1, b1, w2, b2) when H is given), ns with an
    empty lane and a full one, n_iters with a zero budget and a full one
    (lanes 0 and 1 of each, where K allows)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(K, max_n, d)) * 0.2).astype(np.float32)
    y = rng.integers(0, C, (K, max_n)).astype(np.int32)
    ns = rng.integers(1, max_n + 1, K).astype(np.int32)
    n_iters = rng.integers(1, max_iters + 1, K).astype(np.int32)
    ns[0], n_iters[0] = max_n, max_iters
    if K > 1:
        ns[1], n_iters[1] = 0, 0
    if K > 2:
        ns[2] = 0
    idx = (rng.random((K, max_iters, B))
           * np.maximum(ns, 1)[:, None, None]).astype(np.int32)
    if H is None:
        params = ((rng.normal(size=(d, C)) * 0.05).astype(np.float32),
                  (rng.normal(size=C) * 0.1).astype(np.float32))
    else:
        params = ((rng.normal(size=(d, H)) * d ** -0.5).astype(np.float32),
                  (rng.normal(size=H) * 0.1).astype(np.float32),
                  (rng.normal(size=(H, C)) * H ** -0.5).astype(np.float32),
                  (rng.normal(size=C) * 0.1).astype(np.float32))
    return (x, y, idx, *params, ns, n_iters)


def attention_case(B, S, T, Hq, Hkv, hd, seed=42):
    """q [B, S, Hq, hd], k/v [B, T, Hkv, hd] float32 from N(0, 1)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, S, Hq, hd), (B, T, Hkv, hd),
                               (B, T, Hkv, hd)))


def scan_case(B, S, d, N, seed=7):
    """(dt, A, Bmat, Cmat, x, h0) float32 with the reference test's ranges:
    dt in [0.01, 0.5), A in -[0.5, 2)."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.01, 0.5, (B, S, d)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (d, N)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    h0 = rng.normal(size=(B, d, N)).astype(np.float32)
    return dt, A, Bm, Cm, x, h0


def xent_case(T, d, V, seed=21):
    """(h [T, d], W [d, V] * 0.05, labels [T] int32) as the reference's
    cross-entropy tests make them."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(T, d)).astype(np.float32)
    W = (rng.normal(size=(d, V)) * 0.05).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    return h, W, labels


def pitched_xent_case(T, d, V, pitch, seed=21):
    """``xent_case``'s (h, W, labels) with W also laid in a [d, pitch]
    buffer (pitch >= V) whose columns at and past V hold NaN: (h, W,
    buffer, labels); a kernel that reads past V shows it."""
    h, W, labels = xent_case(T, d, V, seed)
    buf = np.full((d, pitch), np.nan, np.float32)
    buf[:, :V] = W
    return h, W, buf, labels


def _slice(P, cs):
    """A rank's slice length at cluster size cs (the compressor's plan)."""
    return 4 * -(-(-(-P // cs)) // 4)


#: the compressor's card cases: name -> (K, P, cluster, route)
COMPRESS_CASES = {
    "straddle": (3, 40_000, 8, None),
    "straddle_streamed": (3, 40_000, 8, "streamed"),
    "straddle_dense": (3, 40_000, 8, None),
    "p_below_cluster": (3, 5, 8, None),
    "p_ragged": (4, 1_001, 8, None),
    "p_ragged_default": (4, 1_001, None, None),
    "amax_last_negative": (2, 51_930, None, None),
    "signed_zero_subnormal": (2, 4_099, 4, None),
    "all_equal_and_zero": (3, 20_410, None, None),
    "k20": (20, 51_930, 8, None),
    "k50": (50, 51_930, 8, None),
    "streamed_row": (1, 500_001, None, None),
    "misaligned": (3, 20_411, None, None),
}


def compress_case(name, seed=5):
    """(ef [K, P] float32, [k, ...]) of a compressor case: N(0, 1e-3)
    deltas, shaped as the name says.

    straddle: one tied magnitude in every row, on every 11th coordinate
    from rank 3's slice on at cluster size 8 (the earliest ties sit in a
    later rank), with k cutting the ties inside rank 5's slice;
    straddle_dense: the same on every 5th coordinate, more ties than the
    kernel gathers for its local finish (4,096); amax_last_negative: |e| ==
    amax only on a negative entry in the last rank's slice;
    signed_zero_subnormal: -0.0, +0.0 and subnormals (ties among them at
    the threshold); all_equal_and_zero: one row of one value, one zero
    row; the others plain rows at the case's shape."""
    K, P, _, _ = COMPRESS_CASES[name]
    rng = np.random.default_rng(seed)
    ef = (rng.normal(size=(K, P)) * 1e-3).astype(np.float32)
    ks = sorted({0, 1, max(P - 1, 0), P, max(1, P // 10)})
    if name.startswith("straddle"):
        S = _slice(P, 8)
        v = np.float32(2.5e-3)
        ef[np.abs(ef) >= v] = np.float32(1e-3)   # nothing above the ties
        step = 5 if name == "straddle_dense" else 11
        ef[:, 3 * S::step] = v
        ef[1, 3 * S::2 * step] = -v
        ef[2, :5] = np.float32(4e-3)             # a few above, in rank 0
        ties = np.arange(P)[3 * S::step]
        cut = int(np.searchsorted(ties, 5 * S + S // 2))
        ks = [cut, cut + 1, 5, len(ties) - 1, len(ties) + 5]
    elif name == "amax_last_negative":
        ef[:, -3] = np.float32(-0.5)
    elif name == "signed_zero_subnormal":
        ef[:, ::3] = np.float32(-0.0)
        ef[:, 1::3] = np.float32(0.0)
        ef[0, 2::6] = np.float32(1e-40)           # subnormal ties
        ef[0, 5::6] = np.float32(-3e-41)
        ef[1] = np.float32(1e-42) * rng.integers(-5, 6, P).astype(np.float32)
        ks = [1, 7, P // 6, P // 3, P // 2, P - 1]
    elif name == "all_equal_and_zero":
        ef[0] = np.float32(-7e-4)
        ef[1] = 0.0
    return ef, ks


def lstm_case(vocab=260, B=10, S=25, E=32, H=64, seed=31):
    """The Sent140 LSTM's params (the reference's init distributions) and
    one padded batch: tokens [B, S] int32 (a few repeated, so the
    embedding's gradient sums rows), labels, a mask with two padded
    rows."""
    rng = np.random.default_rng(seed)
    params = {"emb": rng.normal(size=(vocab, E)) * 0.1,
              "wx": rng.normal(size=(E, 4 * H)) * E ** -0.5,
              "wh": rng.normal(size=(H, 4 * H)) * H ** -0.5,
              "b": rng.normal(size=4 * H) * 0.1,
              "w_out": rng.normal(size=(H, 2)) * H ** -0.5,
              "b_out": rng.normal(size=2) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.integers(0, vocab, (B, S)).astype(np.int32)
    x[1, :5] = x[0, :5]
    mask = np.ones(B, np.float32)
    mask[-2:] = 0.0
    return params, {"x": x, "y": rng.integers(0, 2, B).astype(np.int32),
                    "mask": mask}


def robust_stack_case(K=10, P=56_962, seed=13):
    """A [K, P] upload stack for the robust aggregators, as a params dict
    {"a": [K, P - 6], "b": [K, 6]}: clients at distinct distances from a
    common centre (so no two Krum scores tie), a far-out adversarial row
    (client 3, +50 on every coordinate) and a dropped client (weight 0,
    client 6); the global and the weights n_k in [1, 300)."""
    rng = np.random.default_rng(seed)
    centre = rng.normal(size=P) * 0.1
    spread = np.linspace(0.01, 0.1, K)[rng.permutation(K)]
    flat = (centre[None, :] + spread[:, None]
            * rng.normal(size=(K, P))).astype(np.float32)
    flat[3] += 50.0
    glob = (centre + 0.01 * rng.normal(size=P)).astype(np.float32)
    w = rng.integers(1, 300, K).astype(np.float32)
    w[6] = 0.0
    return ({"a": flat[:, :-6], "b": flat[:, -6:]},
            {"a": glob[:-6], "b": glob[-6:]}, w)


#: the robust aggregators' card cases: (name, keyword arguments)
ROBUST_CASES = [
    ("trimmed_mean", dict(trim_ratio=0.2)),
    ("median", {}),
    ("krum", dict(n_byzantine=1)),
    ("geometric_median", {}),
    ("bulyan", dict(n_byzantine=1)),
    ("trimmed_mean", dict(trim_ratio=0.2, weighted=True)),
    ("krum", dict(n_byzantine=1, multi=3, weighted=True)),
    ("bulyan", dict(n_byzantine=1, weighted=True)),
]


#: the faulted federations of the card tests: a small FEMNIST-like
#: federation, the config of each path and its fault model's arguments
FAULT_DS = dict(n_clients=30, total=900, dim=64, max_size=40)
FAULT_CFG = dict(algo="ira", n_selected=6, batch_size=4, h_cap=6.0,
                 fixed_epochs=4.0, lr=0.05, sampling="iid")
FAULT_PATHS = {"mclr-iid": {},
               "mlp-topk_q8": dict(model="mlp", upload_compress="topk_q8",
                                   topk_frac=0.1)}


def fault_kwargs(corrupt, prob=0.4, seed=3, **extra):
    """``FaultModel`` arguments: ``corrupt`` at ``prob`` (None: no model)."""
    if corrupt is None:
        return None
    return dict(seed=seed, corrupt=corrupt, corrupt_prob=prob, **extra)


def mclr_init(d=64, C=26, seed=1):
    """MCLR params from numpy: the same init on the card and on the CPU
    (their torch generators draw different ones)."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(d, C)) * 0.01).astype(np.float32),
            "b": np.zeros(C, np.float32)}


def iid_draws(max_iters, B, seed=100):
    """data_draws(t, ids, n) -> idx [K, max_iters, B] int32 uniform in
    [0, max(n_k, 1)), from numpy seeded by the round: the same draws on
    the card and on the CPU."""
    def draws(t, ids, n):
        r = np.random.default_rng(seed + t)
        return (r.random((len(ids), max_iters, B))
                * np.maximum(n, 1)[:, None, None]).astype(np.int32)
    return draws


#: the LM federation of the card tests (an architecture id as the local
#: step): Sent140-like, the test split cut to its first rows
LM_DS = dict(n_clients=8, total=80, vocab=300, max_size=16)
LM_TEST_ROWS = 32
LM_CFG = dict(algo="ira", n_selected=3, batch_size=4, h_cap=2.0,
              fixed_epochs=2.0, lr=5e-3, sampling="iid")


def lm_fed_case(arch="llama3.2-3b", dtype="float32", seed=0):
    """(dataset, step, numpy init) of the LM federation: the smoke config
    of ``arch`` in ``dtype`` as a ``from_model`` step, its params drawn
    once on the CPU (the same init on the card and on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_to_numpy
    from repro_torch.data.federated import (FederatedDataset,
                                            make_sent140_like)
    from repro_torch.models.api import from_model
    ds = make_sent140_like(**LM_DS)
    ds = FederatedDataset(ds.name, ds.clients_x, ds.clients_y,
                          ds.test_x[:LM_TEST_ROWS], ds.test_y[:LM_TEST_ROWS],
                          ds.n_classes, task="text")
    step = from_model(get_config(arch, smoke=True).replace(dtype=dtype))
    init = params_to_numpy(step.init_params(
        torch.Generator("cpu").manual_seed(seed)))
    return ds, step, init


def padded_round_case(sampling, max_iters=40, B=4, seed=3):
    """The seed round's inputs on ``FAULT_DS``: 10 clients host-stacked
    (``stacked``), budgets from 0 to ``max_iters``, and numpy draws (idx
    [10, max_iters, B] iid, u [10, max_n] shuffle)."""
    from repro_torch.data.federated import make_femnist_like
    ds = make_femnist_like(**FAULT_DS)
    x, y, mask, n = ds.stacked(np.arange(0, 30, 3), int(ds.sizes.max()))
    n_iters = np.array([0, 3, 12, 40, 7, 1, 0, 25, 9, 40], np.int32)
    r = np.random.default_rng(seed)
    draws = ((r.random((10, max_iters, B)) * np.maximum(n, 1)[:, None, None])
             .astype(np.int32) if sampling == "iid"
             else r.random((10, x.shape[1])).astype(np.float32))
    return ds, (x, y, mask, n, n_iters), draws


def moe_case(S, B=2, seed=1):
    """x [B, S, 128] float32 and a cotangent of its shape: the MoE smoke
    width (granite-moe-1b-a400m's)."""
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, 128)).astype(np.float32),
            r.normal(size=(B, S, 128)).astype(np.float32))


#: the dry-run's reduced step traces, shared by the CPU tests
#: (test_torch_launch.py) and the card tests: (arch, kind, seq_len, batch);
#: the trace's arguments are zeros on a real device (``launch.steps.
#: trace_step``), its token ids the first of the vocabulary
DRYRUN_CASES = (("llama3.2-3b", "train", 64, 2),
                ("llama3.2-3b", "prefill", 64, 2),
                ("llama3.2-3b", "decode", 64, 2),
                ("falcon-mamba-7b", "train", 9, 2),
                ("falcon-mamba-7b", "prefill", 64, 2),
                ("whisper-tiny", "train", 64, 2))
