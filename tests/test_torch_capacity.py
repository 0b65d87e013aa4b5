"""Capacity-compacted cohort execution of the port
(``ServerConfig(mesh_shards=S, cohort_capacity=...)``) against the
reference's.

  * pure functions, bitwise the reference's: ``resolve_capacity``,
    ``cohort_shard_ranks``, ``cohort_overflow`` and ``compact_lane_map``
    (the partition over populations, shard counts and capacities, ghost
    and starved shards, the all-on-one-shard worst case, duplicate
    owners);
  * one rank (an in-process world-1 gloo group): capacity K through the
    compacted lanes and capacity 2 with six slots overflowing each round,
    against the reference's 1-shard mesh run with its draws injected;
    capacity K bitwise "full", and the overflowing run's scan driver
    bitwise its host driver;
  * four spawned gloo ranks: a capacity-2 run with the MLP, topk_q8
    compression and explode faults under the screen, against the
    reference's own 4-device run (``REPRO_FORCE_HOST_DEVICES=4`` in a
    subprocess, nothing in the reference changed): cohorts, L/H/theta,
    the overflowed/dropped counters and the lane occupancy bitwise;
    params, values, losses and the residual within 2e-5.
"""
import datetime
import os
import pickle
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_shard_worker as worker
from repro.core import selection as jsel
from repro.core.engine import RoundEngine as JEngine
from repro.core.server import FedSAEServer as JServer
from repro.core.server import ServerConfig as JConfig
from repro.data.federated import make_femnist_like as jfemnist
from repro.models.fl_models import make_mclr as jmclr
from repro_torch.core import selection as tsel
from repro_torch.core.engine import RoundEngine
from repro_torch.core.server import FedSAEServer, ServerConfig
from repro_torch.data.federated import make_femnist_like
from repro_torch.launch.mesh import spawn_world
from repro_torch.models.fl_models import make_mclr
from torch_cases import one_torch_thread  # noqa: F401
from torch_shard_cases import (BASE, DS24, TOL, assert_matches_reference,
                               assert_same_run, reference_draws,
                               spy_budgets)

ROOT = os.path.join(os.path.dirname(__file__), "..")
T = BASE["rounds"]


@pytest.fixture
def world1():
    """This process as the only rank of a gloo group, for one test."""
    tmp = tempfile.mkdtemp(prefix="world1_")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the capacity functions, bitwise the reference's
# ---------------------------------------------------------------------------


def test_resolve_capacity_matches_reference():
    for spec, k, s in (("full", 10, 4), (None, 10, 0), ("auto", 30, 8),
                       ("auto", 8, 1), (3, 8, 2), (99, 8, 2), ("auto", 7, 3)):
        assert tsel.resolve_capacity(spec, k, s) == \
            jsel.resolve_capacity(spec, k, s)
    assert tsel.AUTO_CAPACITY_SLACK == jsel.AUTO_CAPACITY_SLACK
    with pytest.raises(ValueError, match="requires mesh sharding"):
        tsel.resolve_capacity("auto", 10, 0)
    with pytest.raises(ValueError, match=">= 1"):
        tsel.resolve_capacity(0, 10, 2)


def test_capacity_requires_mesh_at_server_and_engine():
    """The reference's two refusals: the server's (through
    ``resolve_capacity``) and the engine's."""
    with pytest.raises(ValueError, match="requires mesh sharding"):
        FedSAEServer(make_femnist_like(**DS24), cfg=ServerConfig(
            device="cpu", n_selected=8, cohort_capacity=2))
    with pytest.raises(ValueError, match="requires a sharded mesh") as got:
        RoundEngine(lr=0.03).make_packed_round(make_mclr(16, 26), 10, 6, 60,
                                               capacity=4)
    with pytest.raises(ValueError) as want:
        JEngine(lr=0.03).make_packed_round(jmclr(16, 26), 10, 6, 60,
                                           capacity=4)
    assert str(got.value) == str(want.value)


def _check_partition(ids, n_shards, C, capacity):
    """Bitwise the reference's overflow and lane maps, and a partition:
    every kept slot runs in exactly one lane of its own shard, in slot
    order; an overflowed slot runs nowhere."""
    K = len(ids)
    ovf = tsel.cohort_overflow(torch.as_tensor(ids), C, capacity).numpy()
    np.testing.assert_array_equal(
        ovf, np.asarray(jsel.cohort_overflow(ids, C, capacity)))
    executed = []
    for s in range(n_shards):
        lane = tsel.compact_lane_map(torch.as_tensor(ids), C, s,
                                     capacity).numpy()
        np.testing.assert_array_equal(
            lane, np.asarray(jsel.compact_lane_map(ids, C, s, capacity)))
        valid = lane[lane < K]
        assert all(ids[k] // C == s for k in valid)
        assert list(valid) == sorted(valid)
        executed.extend(valid.tolist())
    assert sorted(executed) == np.flatnonzero(~ovf).tolist()


def test_compaction_partition_matches_reference():
    """Random populations, shard counts (ghost-padded or not), cohort
    sizes and capacities."""
    rng = np.random.default_rng(0)
    for _ in range(8):
        n = int(rng.integers(2, 65))
        shards = int(rng.integers(1, 13))
        C = -(-n // shards)
        k = int(rng.integers(1, min(n, 12) + 1))
        capacity = int(rng.integers(1, k + 1))
        _check_partition(rng.permutation(n)[:k], shards, C, capacity)


@pytest.mark.parametrize("n,shards,k,capacity", [
    (5, 8, 3, 1), (6, 4, 4, 2), (10, 7, 10, 1)])
def test_compaction_ghost_and_starved_shards(n, shards, k, capacity):
    rng = np.random.default_rng(n * 100 + shards)
    C = -(-n // shards)
    for _ in range(5):
        _check_partition(rng.choice(n, k, replace=False), shards, C,
                         capacity)


def test_compaction_worst_case_all_clients_on_one_shard():
    C, shards, K = 10, 4, 8
    ids = np.arange(K)
    for capacity in (1, 3, 8):
        np.testing.assert_array_equal(
            tsel.cohort_overflow(torch.as_tensor(ids), C, capacity).numpy(),
            np.arange(K) >= capacity)
        for s in range(1, shards):
            assert (tsel.compact_lane_map(torch.as_tensor(ids), C, s,
                                          capacity) == K).all()
        _check_partition(ids, shards, C, capacity)


def test_shard_ranks_count_duplicate_owners():
    ids = np.array([0, 5, 1, 9, 2, 8])         # C=5: shards 0,1,0,1,0,1
    got = tsel.cohort_shard_ranks(torch.as_tensor(ids), 5).numpy()
    np.testing.assert_array_equal(got, [0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(
        got, np.asarray(jsel.cohort_shard_ranks(ids, 5)))


# ---------------------------------------------------------------------------
# one rank: capacity K (compacted) and capacity 2 (overflow)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("driver,sampling,capacity", [
    ("scan", "shuffle", 8), ("host", "iid", 2)])
def test_one_rank_capacity_matches_reference(world1, driver, sampling,
                                             capacity):
    cfg = dict(BASE, sampling=sampling, driver=driver,
               rng_impl="device" if driver == "host" else "")
    with pytest.MonkeyPatch.context() as mp:
        budgets = spy_budgets(mp)
        jsrv = JServer(jfemnist(**DS24), cfg=JConfig(
            **dict(cfg, mesh_shards=1, cohort_capacity=capacity)))
        init = jax.tree.map(np.asarray, jsrv.params)
        jsrv.run()
    device, data = reference_draws(jsrv, T, jitted_E=driver == "scan")
    case = {"ds": DS24, "init": init, "device_draws": device,
            "data_draws": data,
            "cfg": dict(cfg, mesh_shards=1, cohort_capacity=capacity)}
    got = worker.run_case(case)
    assert_matches_reference(got, jsrv, budgets)
    ovf = got["history"]["overflowed"]
    if capacity == 8:                      # the compacted lanes: bitwise
        assert not ovf.any()               # the masked mode's run
        assert_same_run(got, worker.run_case(dict(
            case, cfg=dict(case["cfg"], cohort_capacity="full"))))
        return
    assert (ovf == 6.0).all() and (got["history"]["dropped"] >= 6.0).all()
    ids = got["cohorts"][0]
    assert (got["budgets"][0][2:] == 0).all()     # slot order: 2 kept
    # the crash branch from the (1.0, 2.0) init pair: L and H halved
    first = [g for g in ids[2:] if g not in got["cohorts"][1:].ravel()]
    assert all(got["L"][g] == 0.5 and got["H"][g] == 1.0 for g in first)
    # the overflowing run's scan driver: bitwise its host driver
    scan = worker.run_case(dict(case, device_draws=None, data_draws=None,
                                cfg=dict(case["cfg"], driver="scan",
                                         rng_impl="")))
    host = worker.run_case(dict(case, device_draws=None, data_draws=None))
    for k in ("cohorts", "budgets", "L", "H", "theta", "values"):
        np.testing.assert_array_equal(scan[k], host[k], err_msg=k)
    for k in scan["params"]:
        np.testing.assert_array_equal(scan["params"][k], host["params"][k])


# ---------------------------------------------------------------------------
# four spawned ranks against the reference's own 4-device run
# ---------------------------------------------------------------------------

S4_CFG = dict(BASE, model="mlp", sampling="iid", upload_compress="topk_q8",
              topk_frac=0.2, driver="scan", mesh_shards=4,
              cohort_capacity=2)
S4_FAULTS = dict(seed=3, corrupt="explode", corrupt_prob=0.3)

#: runs in a fresh interpreter with four simulated host devices (the
#: reference's own hook, set before JAX initializes)
S4_REFERENCE = r"""
import pickle, sys
from repro.launch.hostdev import force_from_env
force_from_env()
import jax
import numpy as np
sys.path.insert(0, sys.argv[2])
from torch_shard_cases import reference_draws, reference_fault_draws
from repro.core.server import FedSAEServer, ServerConfig
from repro.data.federated import make_femnist_like
from repro.faults import FaultModel
spec = pickle.loads(bytes.fromhex(sys.argv[3]))
assert len(jax.devices()) == 4
fm = FaultModel(**spec["faults"])
srv = FedSAEServer(make_femnist_like(**spec["ds"]),
                   cfg=ServerConfig(faults=fm, **spec["cfg"]),
                   telemetry=True)
init = jax.tree.map(np.asarray, srv.params)
srv.run()
T = spec["cfg"]["rounds"]
device, data = reference_draws(srv, T, jitted_E=True)
out = {"init": init, "device": device, "data": data,
       "faults": reference_fault_draws(fm, T, srv.ds.n_clients),
       "cohorts": np.stack(srv.cohorts), "L": srv.L, "H": srv.H,
       "theta": srv.theta, "values": srv.values.v,
       "params": jax.tree.map(np.asarray, srv.params),
       "residual": np.asarray(srv.residual),
       "history": {k: np.asarray(v) for k, v in srv.history.items()},
       "lane_occupancy": [r.lane_occupancy for r in srv._records.records],
       "screened": [r.screened for r in srv._records.records]}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def four_shards(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s4") / "reference.pkl")
    spec = {"ds": DS24, "cfg": S4_CFG, "faults": S4_FAULTS}
    env = dict(os.environ, REPRO_FORCE_HOST_DEVICES="4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-c", S4_REFERENCE, path, os.path.dirname(__file__),
         pickle.dumps(spec).hex()], env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(path, "rb") as f:     # written by the subprocess above
        ref = pickle.load(f)
    case = {"ds": DS24, "cfg": dict(S4_CFG, faults=S4_FAULTS),
            "init": ref["init"], "device_draws": ref["device"],
            "data_draws": ref["data"], "fault_draws": ref["faults"],
            "telemetry": True}
    return ref, spawn_world(worker.run_cases, 4, args=([case],))


def test_four_ranks_capacity_overflow_matches_reference(four_shards):
    ref, ranks = four_shards
    got = [r["cases"][0] for r in ranks]
    h = ref["history"]
    assert h["overflowed"].sum() > 0 and sum(ref["screened"]) > 0
    for g in got:
        np.testing.assert_array_equal(g["cohorts"], ref["cohorts"])
        for name in ("L", "H", "theta"):
            np.testing.assert_array_equal(g[name], ref[name])
        for k in ("overflowed", "dropped", "dropout"):
            np.testing.assert_array_equal(g["history"][k], h[k], err_msg=k)
        assert [r["screened"] for r in g["records"]] == ref["screened"]
        np.testing.assert_allclose(g["values"], ref["values"], rtol=TOL,
                                   atol=TOL)
        for k, v in g["params"].items():
            np.testing.assert_allclose(v, ref["params"][k], rtol=TOL,
                                       atol=TOL)
        np.testing.assert_allclose(g["history"]["train_loss"],
                                   h["train_loss"], rtol=TOL, atol=TOL)
        assert [r["lane_occupancy"] for r in g["records"]] == \
            ref["lane_occupancy"]
    # each rank holds its own rows of the reference's [S, C, P] residual
    for rank, g in enumerate(got):
        np.testing.assert_allclose(g["residual"], ref["residual"][rank],
                                   rtol=TOL, atol=TOL)
