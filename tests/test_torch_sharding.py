"""Client-axis sharding of the port (``ServerConfig(mesh_shards=S)``, one
process per shard in a ``torch.distributed`` group) against the
reference's mesh sharding.

  * pure functions: the sharded packed layout bitwise the reference's at
    S in {1, 2, 3, 5, 8}; the local top-k -> all-gather -> merge selection
    bitwise the reference's ``select_cohort_sharded`` and its replicated
    Gumbel-top-k, ghost-padded and starved shards included;
  * one rank: an in-process world-1 gloo group; both drivers and both
    samplings against the reference's 1-shard mesh run with its draws
    injected, and bitwise the port's replicated run from the same draws;
  * spawned worlds (``launch.mesh.spawn_world``, gloo): S = 2 over 25
    clients (one ghost) and S = 4 over 24, both drivers, against the
    reference's replicated run from the same injected draws (cohorts,
    budgets, L/H/theta and the counters bitwise; params, values and losses
    within 2e-5) and bitwise the port's replicated run; every rank keeps
    the same history; kill/resume bitwise with the residual gathered into
    [S, C, P] by rank 0 and re-sliced on restore; the CLI's ``--shards``.
"""
import datetime
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_shard_worker as worker
from repro.core.selection import select_cohort_device as jselect_device
from repro.core.selection import select_cohort_sharded as jselect_sharded
from repro.core.server import FedSAEServer as JServer
from repro.core.server import ServerConfig as JConfig
from repro.data.federated import make_femnist_like as jfemnist
from repro_torch.core import selection as tsel
from repro_torch.core.server import FedSAEServer, ServerConfig
from repro_torch.data.federated import make_femnist_like
from repro_torch.launch import fl_train
from repro_torch.launch.mesh import (DataGroup, all_gather_1d,
                                     all_reduce_sum, make_data_group,
                                     spawn_world)
from torch_cases import one_torch_thread  # noqa: F401
from torch_shard_cases import (BASE, DS24, DS25, assert_matches_reference,
                               assert_same_run, reference_draws,
                               spy_budgets)

T = BASE["rounds"]


@pytest.fixture
def world1():
    """This process as the only rank of a gloo group (torn down after the
    test, so no other test sees a group)."""
    tmp = tempfile.mkdtemp(prefix="world1_")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the sharded layout and the sharded selection (pure functions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 3, 5, 8])
def test_packed_sharded_layout_bitwise_reference(shards):
    want = jfemnist(**DS25).packed(shards=shards)
    got = make_femnist_like(**DS25).packed(shards=shards)
    assert (got.n_shards, got.clients_per_shard, got.max_n) == (
        want.n_shards, want.clients_per_shard, want.max_n)
    for name in ("x", "y", "offsets", "lengths"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_shard_keeps_one_block():
    whole = make_femnist_like(**DS25).packed(shards=3)
    for rank in range(3):
        part = whole.shard(rank, "cpu")
        assert part.rank == rank and part.n_shards == 3
        for name in ("x", "y", "offsets", "lengths"):
            assert torch.equal(getattr(part, name),
                               getattr(whole, name)[rank])
    with pytest.raises(ValueError, match="whole sharded layout"):
        make_femnist_like(**DS25).packed(device="cpu").shard(0, "cpu")
    with pytest.raises(ValueError, match="whole sharded layout"):
        whole.shard(0, "cpu").shard(0, "cpu")
    with pytest.raises(ValueError, match="outside"):
        whole.shard(3, "cpu")
    with pytest.raises(ValueError, match="shards must be >= 1"):
        make_femnist_like(**DS25).packed(shards=-2)


@pytest.mark.parametrize("shards", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("strategy", ["random", "active",
                                      "loss_proportional"])
def test_sharded_selection_bitwise_reference(shards, strategy):
    """The port's local top-k -> merge returns the reference's sharded and
    replicated cohorts for the reference's Gumbel draws (equal values
    planted: ties resolve lowest index first)."""
    rng = np.random.default_rng(shards)
    n = 37
    values = rng.uniform(0.0, 50.0, n).astype(np.float32)
    values[5:9] = values[4]
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        g = np.asarray(jax.random.gumbel(key, (n,), np.float32))
        for use_al in (False, True):
            want = np.asarray(jselect_sharded(key, values, 8, shards,
                                              strategy, 0.05, use_al))
            np.testing.assert_array_equal(
                want, np.asarray(jselect_device(key, values, 8, strategy,
                                                0.05, use_al)))
            got = tsel.select_cohort_sharded(
                torch.from_numpy(g), torch.from_numpy(values), 8, shards,
                strategy, 0.05, use_al)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,shards,k", [(5, 8, 3), (6, 4, 2), (7, 3, 5),
                                        (10, 7, 10)])
def test_sharded_selection_ghost_and_starved_shards(n, shards, k):
    """More shards than clients, ghost-padded blocks, K above every
    shard's population, K == N: the merge is still exact and never picks
    a ghost."""
    rng = np.random.default_rng(n * 100 + shards)
    values = rng.uniform(0.0, 50.0, n).astype(np.float32)
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        g = torch.from_numpy(np.asarray(jax.random.gumbel(key, (n,),
                                                          np.float32)))
        for strategy in ("random", "active", "loss_proportional"):
            want = np.asarray(jselect_sharded(key, values, k, shards,
                                              strategy))
            got = tsel.select_cohort_sharded(g, torch.from_numpy(values), k,
                                             shards, strategy).numpy()
            np.testing.assert_array_equal(got, want)
            assert (got < n).all()


def test_candidates_and_merge_bitwise_reference():
    from repro.core import selection as jsel
    rng = np.random.default_rng(3)
    scores = rng.normal(size=22).astype(np.float32)
    scores[[2, 9, 17]] = scores[4]                     # ties
    jpad, jC = jsel.pad_scores(scores, 4)
    tpad, tC = tsel.pad_scores(torch.from_numpy(scores), 4)
    assert jC == tC == 6
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    cands = []
    for s in range(4):
        jv, ji = jsel.local_topk_candidates(jpad, s, 6, 5)
        tv, ti = tsel.local_topk_candidates(tpad, s, 6, 5)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        cands.append((tv, ti))
    want = jsel.merge_topk_candidates(
        np.stack([np.asarray(v) for v, _ in cands]),
        np.stack([np.asarray(i) for _, i in cands]), 24, 5)
    got = tsel.merge_topk_candidates(torch.stack([v for v, _ in cands]),
                                     torch.stack([i for _, i in cands]),
                                     24, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------------


def test_mesh_needs_a_process_group():
    """As the reference's ``make_data_mesh`` raises without the devices:
    no group, no sharded server (and no fallback to a replicated run)."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        make_data_group(2)
    with pytest.raises(ValueError, match="process group"):
        FedSAEServer(make_femnist_like(**DS24), cfg=ServerConfig(
            device="cpu", mesh_shards=2))
    with pytest.raises(ValueError, match=">= 1"):
        make_data_group(0)


def test_data_group_and_collectives(world1):
    assert make_data_group(1) == DataGroup(0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="has 1 ranks"):
        make_data_group(2)
    x = torch.tensor([1.5, -0.0, 3.0])
    assert torch.equal(all_gather_1d(x), x[None])
    out = all_reduce_sum(x)
    assert torch.equal(out, x) and out is not x


def test_sharded_refusals(world1):
    """The reference's errors: quarantine and prefetch on a mesh."""
    ds = make_femnist_like(**DS24)
    with pytest.raises(ValueError, match="quarantine is not supported on "
                                         "a sharded mesh"):
        FedSAEServer(ds, cfg=ServerConfig(
            device="cpu", mesh_shards=1, upload_screen="on",
            rng_impl="device", quarantine_threshold=0.5))
    with pytest.raises(ValueError, match="not supported on a sharded mesh"):
        FedSAEServer(ds, cfg=ServerConfig(
            device="cpu", mesh_shards=1, driver="scan",
            prefetch="double_buffer"))


# ---------------------------------------------------------------------------
# one rank (in-process world-1 group) against the reference's 1-shard mesh
# ---------------------------------------------------------------------------


_REFERENCE = {}


def _reference(ds, driver, sampling, mesh_shards=0):
    """The reference's run (its budgets recorded) and the port's case
    with its draws injected, each computed once per module."""
    key = (ds["n_clients"], driver, sampling, mesh_shards)
    if key in _REFERENCE:
        return _REFERENCE[key]
    cfg = dict(BASE, sampling=sampling, driver=driver,
               rng_impl="device" if driver == "host" else "")
    with pytest.MonkeyPatch.context() as mp:
        budgets = spy_budgets(mp)
        jsrv = JServer(jfemnist(**ds), cfg=JConfig(
            **dict(cfg, mesh_shards=mesh_shards)))
        init = jax.tree.map(np.asarray, jsrv.params)
        jsrv.run()
    device, data = reference_draws(jsrv, T, jitted_E=driver == "scan")
    case = {"ds": ds, "init": init, "device_draws": device,
            "data_draws": data, "cfg": cfg}
    _REFERENCE[key] = (jsrv, list(budgets), case)
    return _REFERENCE[key]


@pytest.mark.parametrize("driver", ["host", "scan"])
@pytest.mark.parametrize("sampling", ["shuffle", "iid"])
def test_one_rank_matches_reference_one_shard_mesh(world1, driver,
                                                   sampling):
    jsrv, budgets, case = _reference(DS24, driver, sampling, 1)
    sharded = worker.run_case(dict(case, cfg=dict(case["cfg"],
                                                  mesh_shards=1)))
    assert_matches_reference(sharded, jsrv, budgets)
    assert_same_run(sharded, worker.run_case(case))


# ---------------------------------------------------------------------------
# spawned worlds: S = 2 over 25 clients (one ghost), S = 4 over 24
# ---------------------------------------------------------------------------

#: case name -> (world size, federation, driver, sampling, the mesh of
#: the reference's run: the S = 4 cases share the one-rank cases'
#: 1-shard runs, bitwise its replicated runs by the reference's own
#: test_one_shard_mesh_bitwise_equals_replicated)
SPAWNED = {
    "S2-scan-shuffle": (2, DS25, "scan", "shuffle", 0),
    "S2-host-iid": (2, DS25, "host", "iid", 0),
    "S4-scan-iid": (4, DS24, "scan", "iid", 1),
    "S4-host-shuffle": (4, DS24, "host", "shuffle", 1),
}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every spawned case, each world started once: the reference's runs,
    their draws, the port's replicated runs, and each world's ranks'
    results (plus, on S = 2, the numpy host driver, a kill/resume of the
    MLP + topk_q8 and nan uploads under the screen)."""
    refs, cases = {}, {2: [], 4: []}
    for name, (S, ds, driver, sampling, mesh) in SPAWNED.items():
        jsrv, budgets, case = _reference(ds, driver, sampling, mesh)
        refs[name] = (jsrv, budgets, worker.run_case(case), len(cases[S]))
        cases[S].append(dict(case, cfg=dict(case["cfg"], mesh_shards=S)))
    # the numpy host driver (its own numpy streams, bitwise the
    # reference's: test_torch_server.py): bitwise the port's replicated
    # run
    numpy_host = {"ds": DS25, "cfg": dict(BASE, sampling="iid")}
    refs["S2-numpy-host-iid"] = (None, None, worker.run_case(numpy_host),
                                 len(cases[2]))
    cases[2].append(dict(numpy_host, cfg=dict(numpy_host["cfg"],
                                              mesh_shards=2)))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    mlp = dict(BASE, model="mlp", sampling="iid", upload_compress="topk_q8",
               topk_frac=0.2, driver="host", rng_impl="device",
               mesh_shards=2)
    straight = {"ds": DS25, "cfg": mlp, "telemetry": True}
    refs["S2-kill-resume"] = (None, None, None, len(cases[2]))
    cases[2] += [straight, dict(straight, resume_at=3, ckpt=ckpt)]
    # nan uploads under the screen (injected after the rebuild), the
    # port's own streams: bitwise the port's replicated run
    nan = {"ds": DS25, "cfg": dict(BASE, sampling="iid", driver="host",
                                   rng_impl="device", faults=dict(
                                       seed=3, corrupt="nan",
                                       corrupt_prob=0.4))}
    refs["S2-nan"] = (None, None, worker.run_case(nan), len(cases[2]))
    cases[2].append(dict(nan, cfg=dict(nan["cfg"], mesh_shards=2)))
    worlds = {S: spawn_world(worker.run_cases, S, args=(cases[S],))
              for S in (2, 4)}
    return refs, worlds


def test_spawned_collectives(spawned):
    """Four gloo ranks: each rank's all-gather holds every rank's vector
    in rank order, and the all-reduce is their sum."""
    _, worlds = spawned
    for g, s in (r["collectives"] for r in worlds[4]):
        assert torch.equal(g, torch.arange(4.0)[:, None]
                           + torch.zeros(1, 2))
        assert torch.equal(s, torch.full((2,), 6.0))


@pytest.mark.parametrize("name", list(SPAWNED) + ["S2-numpy-host-iid"])
def test_spawned_matches_reference(spawned, name):
    refs, worlds = spawned
    jsrv, budgets, replicated, at = refs[name]
    S = int(name[1])
    ranks = [r["cases"][at] for r in worlds[S]]
    if jsrv is not None:
        assert_matches_reference(ranks[0], jsrv, budgets)
    for got in ranks:                  # every rank: the replicated run
        assert_same_run(got, replicated)


def test_spawned_nan_uploads_screened_bitwise_replicated(spawned):
    refs, worlds = spawned
    _, _, replicated, at = refs["S2-nan"]
    for r in worlds[2]:
        got = r["cases"][at]
        assert_same_run(got, replicated)
        assert sum(rec["screened"] for rec in got["records"]) > 0


def test_spawned_ghost_client_never_selected(spawned):
    refs, worlds = spawned
    for name in ("S2-scan-shuffle", "S2-host-iid"):
        cohorts = worlds[2][0]["cases"][refs[name][3]]["cohorts"]
        assert cohorts.max() < DS25["n_clients"]


def test_spawned_kill_resume_bitwise(spawned):
    """Kill at round 3, resume in fresh servers: bitwise the straight run
    on every rank; the file's residual is the ranks' rows stacked."""
    refs, worlds = spawned
    at = refs["S2-kill-resume"][3]
    ranks = [r["cases"][at:at + 2] for r in worlds[2]]
    for r in ranks:
        straight, resumed = r
        assert_same_run(straight, resumed)
        np.testing.assert_array_equal(straight["residual"],
                                      resumed["residual"])
        assert straight["records"] == resumed["records"]
    saved = ranks[0][1]["saved_residual"]
    assert saved.shape[0] == 2
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(saved[rank], r[1]["residual"])
    assert np.abs(saved).sum() > 0
    occ = [rec["lane_occupancy"] for rec in ranks[0][0]["records"]]
    assert all(len(o) == 2 and sum(o) == pytest.approx(1.0) for o in occ)


def test_cli_shards_needs_a_card_a_rank():
    """--device cuda --shards S takes one card a rank over NCCL: with
    fewer cards it exits, as the reference's mesh needs S devices."""
    with pytest.raises(SystemExit, match="needs 64 CUDA devices"):
        fl_train.main(["--shards", "64", "--rounds", "1"])


def test_cli_shards_spawns_gloo_ranks(capfd):
    """``fl_train --device cpu --shards 2``: the CLI spawns two gloo ranks;
    rank 0 alone prints, and its history comes back."""
    hist = fl_train.main(["--device", "cpu", "--shards", "2",
                          "--cohort-capacity", "4", "--rounds", "2"])
    assert len(hist["acc"]) == 2 and np.isfinite(hist["train_loss"]).all()
    out = capfd.readouterr().out
    assert out.count("final: acc=") == 1 and "(capacity=4)" in out
    assert out.count("[ira] round   0") == 1
