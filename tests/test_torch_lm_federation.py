"""An architecture id as every client's local step of the packed round
(ROADMAP A13 (iii)): the port against the reference on the same
numpy-made inputs, on the CPU.

The federation is Sent140-like (8 clients, vocabulary 300, at most 16
tweets of 25 tokens a client, the test split cut to 32 rows), K=3, B=4,
h_cap 2 (max_iters 6), lr 5e-3.  Both servers train ``from_model`` of the
Llama-3.2-3B smoke config in float32 (``cfg.replace(dtype="float32")``),
the port from the reference's init (``init_params=``) and its minibatch
draws (``data_draws=``, and ``device_draws=`` for the scan driver).

Bounds: cohorts, budgets and L/H/theta bitwise; params and losses within
1e-4 (ROADMAP "Rules", LM float32); the default bf16 config within 2e-2;
test accuracy within two test tokens.  Compression is held set-wise, as
``test_torch_compression.py`` holds it.  The port's own drivers are held
bitwise to each other: the scan driver to the host driver with device rng,
a gloo world of two ranks to the world-1 run, the nan crash twin, and
kill/resume.
"""
import datetime
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_shard_worker as worker
from repro.configs import get_config as jget_config
from repro.core import compression as jcomp
from repro.core.engine import RoundEngine as JEngine
from repro.core.server import FedSAEServer as JServer
from repro.core.server import ServerConfig as JConfig
from repro.data.federated import FederatedDataset as JDataset
from repro.data.federated import make_femnist_like as jfemnist
from repro.data.federated import make_sent140_like as jsent140
from repro.models.api import from_model as jfrom_model
from repro.models.fl_models import resolve_local_step as jresolve
from repro_torch.convert import params_from_reference
from repro_torch.core import compression as tcomp
from repro_torch.core.engine import RoundEngine as TEngine
from repro_torch.core.rounds import make_eval_fn
from repro_torch.core.server import FedSAEServer as TServer
from repro_torch.core.server import ServerConfig as TConfig
from repro_torch.data.federated import make_femnist_like as tfemnist
from repro_torch.launch import fl_train
from repro_torch.launch.mesh import spawn_world
from repro_torch.models.fl_models import resolve_local_step as tresolve
from repro_torch.tree import tree_items, tree_leaves, tree_unflatten
from test_torch_server import _reference_draws
from torch_cases import one_torch_thread  # noqa: F401
from torch_shard_cases import assert_same_run, reference_draws, spy_budgets

TOL = 1e-4                 # LM values in float32
BF16_TOL = 2e-2            # ... and in bfloat16
DS = dict(n_clients=8, total=80, vocab=300, max_size=16)
TEST_ROWS = 32
CFG = dict(algo="ira", n_selected=3, batch_size=4, rounds=2, h_cap=2.0,
           fixed_epochs=2.0, lr=5e-3, sampling="iid")
LLAMA, FALCON = "llama3.2-3b", "falcon-mamba-7b"


def _jfed():
    ds = jsent140(**DS)
    return JDataset(ds.name, ds.clients_x, ds.clients_y,
                    ds.test_x[:TEST_ROWS], ds.test_y[:TEST_ROWS],
                    ds.n_classes, task="text")


def _tfed():
    return worker.lm_federation(TEST_ROWS, **DS)


def _jstep(arch, dtype="float32"):
    return jfrom_model(jget_config(arch, smoke=True).replace(dtype=dtype))


def _flat(params):
    """A params tree (the reference's numpy one or the port's) as a
    key-path dict of numpy arrays."""
    if not torch.is_tensor(tree_leaves(params)[0]):
        params = params_from_reference(jax.tree.map(np.asarray, params),
                                       "cpu")
    return worker.flat_params(params)


_REF = {}


def _reference(arch=LLAMA, dtype="float32", spec=False, **over):
    """The reference's run (budgets recorded, init kept), once a module.
    ``spec`` resolves the arch id through ``ServerConfig.model`` (its
    default bf16 smoke config) in place of a float32 step object."""
    key = (arch, dtype, spec, tuple(sorted(over.items())))
    if key not in _REF:
        cfg = dict(CFG, **over)
        model = None if spec else _jstep(arch, dtype)
        if spec:
            cfg["model"] = arch
        with pytest.MonkeyPatch.context() as mp:
            budgets = spy_budgets(mp)       # the device round's budgets
            jsrv = JServer(_jfed(), model=model, cfg=JConfig(**cfg))
            init = jax.tree.map(np.asarray, jsrv.params)
            inner = jsrv.round_fn

            def spy(*args):                 # the numpy host driver's
                budgets.append(np.asarray(args[6]))
                return inner(*args)

            jsrv.round_fn = spy
            jhist = jsrv.run()
        _REF[key] = (jsrv, list(budgets), init, jhist, cfg)
    return _REF[key]


def _port(ref, arch=LLAMA, dtype="float32", spec=False, **kw):
    """The port's server on the reference's init and host draws."""
    jsrv, _, init, _, cfg = ref
    model = None if spec else worker.lm_step(arch, dtype)
    if "data_draws" not in kw:
        kw["data_draws"] = _reference_draws(
            cfg.get("seed", 0), cfg["rounds"], jsrv.max_iters,
            cfg["batch_size"], int(jsrv.sizes.max()), cfg["sampling"])
    return TServer(_tfed(), model=model, cfg=TConfig(device="cpu", **cfg),
                   init_params=init, **kw)


def _assert_matches(tsrv, ref, tol, host=True):
    jsrv, budgets, _, jhist, _ = ref
    thist = tsrv.history
    assert tsrv.model.kind == "lm"
    assert tsrv.max_iters == jsrv.max_iters
    for a, b in zip(tsrv.cohorts, jsrv.cohorts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(tsrv.budgets), np.stack(budgets))
    for name in ("L", "H", "theta"):
        np.testing.assert_array_equal(getattr(tsrv, name),
                                      getattr(jsrv, name))
    tp, jp = _flat(tsrv.params), _flat(jsrv.params)
    assert tp.keys() == jp.keys()
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=tol, atol=tol,
                                   err_msg=k)
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(thist[k], jhist[k], rtol=tol, atol=tol,
                                   err_msg=k)
    means = ("dropout", "assigned", "uploaded", "true_workload")
    for k in means:
        if host:
            np.testing.assert_array_equal(thist[k], jhist[k], err_msg=k)
        else:                  # the device round's float32 means
            np.testing.assert_allclose(thist[k], jhist[k], rtol=1e-6,
                                       err_msg=k)
    # the scan evaluates at block ends: NaN before, in both
    np.testing.assert_allclose(thist["acc"], jhist["acc"], rtol=0,
                               atol=2.0 / (TEST_ROWS * (25 - 1)))


# ---------------------------------------------------------------------------
# the arch-id branch of resolve_local_step
# ---------------------------------------------------------------------------


def test_resolve_arch_ids_to_lm_steps():
    tds, jds = _tfed(), _jfed()
    for arch in (LLAMA, FALCON):
        step = tresolve(arch, tds)
        assert step.kind == "lm" and step.leaf_views is not None
        jresolve(arch, jds)                 # the reference's resolves too
    full = worker.lm_step(LLAMA, "bfloat16")
    assert tresolve(full, tds) is full      # a step object passes through


@pytest.mark.parametrize("spec,kind,match", [
    (LLAMA, ValueError, "token-sequence architecture"),
    ("no-such-arch", KeyError, "unknown arch")])
def test_resolve_arch_id_errors_match_reference(spec, kind, match):
    with pytest.raises(kind, match=match):
        tresolve(spec, tfemnist(n_clients=6, total=100, dim=8, max_size=30))
    with pytest.raises(kind, match=match):
        jresolve(spec, jfemnist(n_clients=6, total=100, dim=8, max_size=30))


def test_resolve_vocab_and_unported_archs():
    """A dataset vocabulary past the arch's raises the reference's error;
    the encoder-decoder raises the reference's ``from_model`` error in
    both packages (it is not a decoder-only LM)."""
    big = dict(DS, vocab=600)
    with pytest.raises(ValueError, match="arch vocab 512 < dataset vocab"):
        tresolve(LLAMA, worker.lm_federation(4, **big))
    with pytest.raises(ValueError, match="arch vocab 512 < dataset vocab"):
        jresolve(LLAMA, jsent140(**big))
    match = "from_model supports decoder-only architectures; whisper-tiny"
    with pytest.raises(ValueError, match=match):
        tresolve("whisper-tiny", _tfed())
    with pytest.raises(ValueError, match=match):
        jresolve("whisper-tiny", _jfed())


# ---------------------------------------------------------------------------
# host rounds against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [LLAMA, FALCON])
def test_tree_items_follow_the_reference_leaf_order(arch):
    """The flat [K, P] view's order, shared by the sharded rebuild, the
    compressor and the checkpoint: ``tree_items``' paths in the
    reference's ``jax.tree`` order over the LM's params, and
    ``tree_unflatten`` the inverse of ``tree_leaves``."""
    params = worker.lm_step(arch, "float32").init_params(
        torch.Generator("cpu").manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), params))[0]
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]
    items = tree_items(params)
    assert [k for k, _ in items] == want
    for (_, got), (_, leaf) in zip(items, flat):
        np.testing.assert_array_equal(got.numpy(), leaf)
    doubled = tree_unflatten(params, [v * 2 for v in tree_leaves(params)])
    assert [k for k, _ in tree_items(doubled)] == want
    for (_, got), (_, v) in zip(tree_items(doubled), items):
        assert torch.equal(got, v * 2)


@pytest.mark.parametrize("over", [dict(sampling="iid"),
                                  dict(sampling="shuffle"),
                                  dict(algo="fedprox", sampling="iid")],
                         ids=["iid", "shuffle", "fedprox"])
def test_host_rounds_match_reference(over):
    ref = _reference(**over)
    tsrv = _port(ref)
    tsrv.run()
    _assert_matches(tsrv, ref, TOL)


def test_default_bf16_config_matches_reference():
    """``ServerConfig(model="llama3.2-3b")``: the smoke config as the
    reference's CLI resolves it, bf16 compute, within 2e-2."""
    ref = _reference(spec=True)
    tsrv = _port(ref, spec=True)
    tsrv.run()
    assert tsrv.model.kind == "lm"
    _assert_matches(tsrv, ref, BF16_TOL)


def test_falcon_mamba_round_matches_reference():
    ref = _reference(FALCON, rounds=1)
    tsrv = _port(ref, FALCON)
    tsrv.run()
    _assert_matches(tsrv, ref, TOL)


def test_scan_driver_matches_reference_scan():
    """Both scan drivers, one block of 2 rounds, the reference's draws
    (the workloads E, the Gumbel noise, the minibatches) injected."""
    ref = _reference(driver="scan", block_size=2)
    jsrv = ref[0]
    device, data = reference_draws(jsrv, CFG["rounds"], jitted_E=True)
    tsrv = _port(ref, device_draws=lambda t: device[t],
                 data_draws=lambda t, ids, n: data[t])
    tsrv.run()
    _assert_matches(tsrv, ref, TOL, host=False)


def test_compressed_round_matches_reference_setwise(monkeypatch):
    """One iid round with topk_q8 through each engine: the kept sets agree
    on >= 99.9% of the uploading rows' coordinates, values within 1e-4
    where both kept, the error-feedback identity exact, non-uploaders'
    residuals untouched; the reference's kept set read out of its jitted
    round through a debug callback."""
    jds, tds = _jfed(), _tfed()
    B, max_iters, lr, frac = 4, 4, 5e-3, 0.1
    max_n = int(jds.sizes.max())
    ids = np.array([0, 3, 5])
    n_iters = np.array([0, 2, 4], np.int32)
    jstep = _jstep(LLAMA)
    jparams = jstep.init_params(jax.random.PRNGKey(7))
    P = sum(int(np.size(v)) for v in jax.tree.leaves(jparams))
    residual = np.random.default_rng(4).normal(
        scale=1e-3, size=(jds.n_clients, P)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    seen = {"j": {}, "t": {}}
    j_inner, t_inner = jcomp.compress_rows, tcomp.compress_rows

    def j_capture(ef, k, backend):
        q, scale = j_inner(ef, k, backend)
        jax.debug.callback(lambda v: seen["j"].update(q=np.asarray(v)), q)
        return q, scale

    def t_capture(ef, k):
        q, scale = t_inner(ef, k)
        seen["t"].update(ef=ef.numpy().copy(), q=q.numpy().copy(),
                         scale=scale.numpy().copy())
        return q, scale

    monkeypatch.setattr(jcomp, "compress_rows", j_capture)
    monkeypatch.setattr(tcomp, "compress_rows", t_capture)
    jfn = JEngine(lr=lr, donate=False, compress="topk_q8", topk_frac=frac
                  ).make_packed_round(jstep, B, max_iters, max_n,
                                      sampling="iid")
    pk = jds.packed(max_n)
    jp, jl, _, jres = jfn(jparams, pk.x, pk.y, pk.offsets, pk.lengths,
                          jnp.asarray(ids, jnp.int32), jnp.asarray(n_iters),
                          rng, jnp.asarray(residual))
    jax.effects_barrier()
    n = np.minimum(jds.sizes[ids], max_n)
    keys = jax.random.split(rng, len(ids))
    draws = np.asarray(jax.vmap(lambda k, nk: jax.random.randint(
        k, (max_iters, B), 0, jnp.maximum(nk, 1)))(keys, jnp.asarray(n)))
    tfn = TEngine(lr=lr, compress="topk_q8", topk_frac=frac
                  ).make_packed_round(worker.lm_step(LLAMA, "float32"), B,
                                      max_iters, max_n, sampling="iid")
    tpk = tds.packed(max_n, device="cpu")
    tp, tl, _, tres = tfn(
        params_from_reference(jax.tree.map(np.asarray, jparams), "cpu"),
        tpk.x, tpk.y, tpk.offsets, tpk.lengths, torch.from_numpy(ids),
        torch.from_numpy(n_iters), draws=draws,
        residual=torch.from_numpy(residual.copy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    tres, jres = tres.numpy(), np.asarray(jres)
    up = n_iters > 0
    tkept, jkept = seen["t"]["q"] != 0, seen["j"]["q"] != 0
    assert (tkept == jkept)[up].mean() >= 0.999
    both = tkept & jkept
    np.testing.assert_allclose(tres[ids][both], jres[ids][both], rtol=TOL,
                               atol=TOL)
    sent = seen["t"]["q"].astype(np.float32) * seen["t"]["scale"][:, None]
    np.testing.assert_array_equal((sent + tres[ids])[up],
                                  seen["t"]["ef"][up])
    keep = np.ones(jds.n_clients, bool)
    keep[ids[up]] = False
    np.testing.assert_array_equal(tres[keep], residual[keep])
    same = (tkept == jkept)[up].all(0)
    flat_t = tcomp.flatten_global(tp).numpy()
    flat_j = np.asarray(jcomp.flatten_global(jp))
    np.testing.assert_allclose(flat_t[same], flat_j[same], rtol=TOL,
                               atol=TOL)


def test_eval_takes_the_lm_accuracy_and_loss_in_one_call():
    """The server's eval is the step's accuracy and loss over the whole
    test split, the reference's one call each."""
    tds = _tfed()
    step = worker.lm_step(LLAMA, "float32")
    params = step.init_params(torch.Generator().manual_seed(0))
    x, y = torch.from_numpy(tds.test_x), torch.from_numpy(tds.test_y)
    acc, loss = make_eval_fn(step)(params, x, y)
    assert float(loss) == float(step.loss(params, {"x": x, "y": y}))
    assert float(acc) == float(step.accuracy(params, {"x": x, "y": y}))


# ---------------------------------------------------------------------------
# the port's drivers against each other, bitwise
# ---------------------------------------------------------------------------


def _case(**cfg):
    """A shard-worker case: the LM federation and float32 Llama step."""
    return {"ds": dict(DS, test_rows=TEST_ROWS), "lm": (LLAMA, "float32"),
            "cfg": dict(CFG, **cfg)}


@pytest.mark.parametrize("sampling", ["iid", "shuffle"])
def test_scan_bitwise_host_with_device_rng(sampling):
    """Every lane walks all max_iters slots masked on both device drivers:
    the scan run is bitwise the host run with rng_impl="device"."""
    host = worker.run_case(_case(sampling=sampling, rng_impl="device"))
    scan = worker.run_case(_case(sampling=sampling, driver="scan",
                                 block_size=2))
    for run in (host, scan):            # the scan evaluates at block ends
        for k in ("acc", "test_loss"):
            run["history"].pop(k)
    assert_same_run(scan, host)
    assert scan["records"][-1] == host["records"][-1]


def test_nan_uploads_screened_bitwise_their_crash_twin():
    """nan uploads train with their real budgets and are screened: the
    run is bitwise its corrupt="crash" twin's, the LM tree through the
    injection and the screen."""
    fm = dict(seed=1, corrupt_prob=0.5)
    nan = worker.run_case(_case(faults=dict(fm, corrupt="nan")))
    crash = worker.run_case(_case(faults=dict(fm, corrupt="crash"),
                                  upload_screen="on"))
    for k in ("cohorts", "L", "H", "theta", "values"):
        np.testing.assert_array_equal(nan[k], crash[k], err_msg=k)
    for k in crash["params"]:
        np.testing.assert_array_equal(nan["params"][k], crash["params"][k],
                                      err_msg=k)
    # the faulty clients trained (their budgets) and were screened
    assert (nan["budgets"] >= crash["budgets"]).all()
    assert sum(r["screened"] for r in nan["records"]) > 0


def test_kill_resume_bitwise(tmp_path):
    """Kill after round 1 with a checkpoint, resume in a fresh server:
    bitwise the straight run, the LM tree and the residual saved."""
    case = _case(rounds=2, upload_compress="topk_q8")
    straight = worker.run_case(case)
    resumed = worker.run_case(dict(case, resume_at=1,
                                   ckpt=str(tmp_path / "ckpt")))
    assert_same_run(straight, resumed)
    np.testing.assert_array_equal(straight["residual"], resumed["residual"])
    assert straight["records"] == resumed["records"]


@pytest.fixture(scope="module")
def worlds():
    """The world-1 runs in this process (a one-rank gloo group), then the
    same cases on two spawned gloo ranks."""
    cases = [_case(driver="scan", block_size=2, mesh_shards=1),
             _case(sampling="shuffle", rng_impl="device",
                   upload_compress="topk_q8", mesh_shards=1)]
    tmp = tempfile.mkdtemp(prefix="world1_")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        one = [worker.run_case(c) for c in cases]
    finally:
        dist.destroy_process_group()
    two = spawn_world(worker.run_cases, 2, args=([
        dict(c, cfg=dict(c["cfg"], mesh_shards=2)) for c in cases],))
    return one, two


@pytest.mark.parametrize("at", [0, 1], ids=["scan-iid", "host-shuffle-topk"])
def test_two_gloo_ranks_bitwise_world_one(worlds, at):
    """The stack rebuilt from two ranks' lanes by one SUM all-reduce of
    [K, P + 1]: every rank bitwise the world-1 run."""
    one, two = worlds
    for rank in two:
        assert_same_run(rank["cases"][at], one[at])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_arch_id_runs(capsys):
    """``fl_train --dataset sent140 --model llama3.2-3b``: the reduced
    Sent140 (60 clients) with the smoke LM at lr 5e-3."""
    args = fl_train.parse_args(["--dataset", "sent140", "--model", LLAMA,
                                "--device", "cpu"])
    srv = fl_train.build_server(args)
    assert srv.cfg.lr == 5e-3 and srv.model.kind == "lm"
    hist = fl_train.main(["--dataset", "sent140", "--model", LLAMA,
                          "--device", "cpu", "--rounds", "2", "--quiet"])
    assert len(hist["acc"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert "final: acc=" in capsys.readouterr().out
