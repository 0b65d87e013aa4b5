"""``ServerConfig(prefetch="double_buffer")``, the reference's
``_scan_prefetch``, in the port: accepted, refused where the reference
refuses it, and run as the single-round program of ``prefetch="off"``
(the reference's prefetch reorders the same operations into the same
bits).  Held bitwise to off: params, L/H/theta, values, residual,
quarantine counters, cohorts, budgets and every record but its wall
time, at block sizes 1, 2 and 8, with MCLR and with the MLP, with
compression, faults, the screen and quarantine.
"""
import datetime
import json
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.engine import RoundEngine
from repro_torch.core.heterogeneity import HeterogeneitySim
from repro_torch.core.server import FedSAEServer, ServerConfig
from repro_torch.data.federated import make_femnist_like
from repro_torch.faults import FaultModel
from repro_torch.launch.fl_train import parse_args
from repro_torch.models.fl_models import make_mclr
from torch_cases import one_torch_thread  # noqa: F401

DS = dict(n_clients=24, total=1400, dim=16, max_size=60)
BASE = dict(algo="ira", n_selected=8, rounds=8, h_cap=4.0, fixed_epochs=4.0,
            sampling="iid", driver="scan", device="cpu")

CASES = {
    "mclr": {},
    "mlp-topk_q8-explode": dict(
        model="mlp", upload_compress="topk_q8", topk_frac=0.2,
        faults=FaultModel(seed=3, corrupt="explode", corrupt_prob=0.3)),
    "mclr-shuffle-nan-quarantine": dict(
        sampling="shuffle", faults=FaultModel(seed=3, corrupt="nan",
                                              corrupt_prob=0.4),
        quarantine_threshold=0.3, quarantine_min_tries=1,
        quarantine_rounds=4),
}


def _run(telemetry=True, **cfg):
    srv = FedSAEServer(make_femnist_like(**DS),
                       cfg=ServerConfig(**dict(BASE, **cfg)),
                       telemetry=telemetry)
    srv.run()
    return srv


def _records(srv):
    out = []
    for r in srv._records.records:
        d = json.loads(r.to_json())
        d.pop("wall_time_s")
        out.append(d)
    return out


def _assert_bitwise(a, b):
    for x, y in zip(a.cohorts, b.cohorts, strict=True):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.budgets, b.budgets, strict=True):
        np.testing.assert_array_equal(x, y)
    for name in ("L", "H", "theta", "q_fail", "q_try", "q_susp"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(a.values.v, b.values.v)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert (a.residual is None) == (b.residual is None)
    if a.residual is not None:
        assert torch.equal(a.residual, b.residual)
    assert _records(a) == _records(b)
    assert a.host_syncs == b.host_syncs


@pytest.mark.parametrize("block", [1, 2, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefetch_bitwise_off(case, block):
    off = _run(block_size=block, **CASES[case])
    on = _run(block_size=block, prefetch="double_buffer", **CASES[case])
    _assert_bitwise(off, on)
    if "faults" in CASES[case]:
        assert sum(r.screened for r in on._records.records) > 0


def test_prefetch_partial_final_block_and_resume(tmp_path):
    """Blocks of 3 over 8 rounds (a final block of 2), killed after the
    first block and resumed: bitwise the straight off run."""
    cfg = dict(CASES["mlp-topk_q8-explode"], block_size=3)
    off = _run(**cfg)
    first = FedSAEServer(make_femnist_like(**DS), cfg=ServerConfig(**dict(
        BASE, prefetch="double_buffer", **cfg)), telemetry=True)
    first.run(rounds=3, checkpoint_dir=str(tmp_path))
    resumed = FedSAEServer(make_femnist_like(**DS), cfg=ServerConfig(**dict(
        BASE, prefetch="double_buffer", **cfg)), telemetry=True)
    resumed.run(checkpoint_dir=str(tmp_path), resume=True)
    for k in off.params:
        assert torch.equal(off.params[k], resumed.params[k])
    assert torch.equal(off.residual, resumed.residual)
    assert _records(off) == _records(resumed)


def test_prepare_then_execute_is_one_round():
    """The device round's two halves, prepare then execute, are the round
    ``make_device_round`` returns, bitwise, from the same generators."""
    ds = make_femnist_like(**DS)
    pk = ds.packed(device="cpu")
    het = HeterogeneitySim(ds.n_clients, seed=0)
    mu, sigma = het.device_params("cpu")
    cfg = ServerConfig(**BASE)
    model = make_mclr(DS["dim"], ds.n_classes)
    params = model.init_params(torch.Generator().manual_seed(0))
    N = ds.n_clients
    carry = {"params": params, "values": torch.ones(N),
             "L": torch.ones(N), "H": torch.full((N,), 2.0),
             "theta": torch.full((N,), 1.5)}
    outs = []
    for split in (False, True):
        one = RoundEngine(lr=0.03).make_device_round(
            model, 10, 60, pk, cfg, mu=mu, sigma=sigma,
            sel_gen=torch.Generator().manual_seed(1),
            data_gen=torch.Generator().manual_seed(2))
        outs.append(one.execute(*one.prepare(dict(carry), 0, {})) if split
                    else one(dict(carry), 0, {}))
    (a, sa), (b, sb) = outs
    for k in ("L", "H", "theta", "values"):
        assert torch.equal(a[k], b[k]), k
    for k in params:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_prefetch_sharded_host_driver_runs_off():
    """On a mesh the reference refuses prefetch on the scan driver only:
    a world-1 sharded host driver with prefetch runs bitwise off."""
    tmp = tempfile.mkdtemp(prefix="prefetch_world1_")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        kw = dict(driver="host", rng_impl="device", mesh_shards=1,
                  cohort_capacity=4, **CASES["mlp-topk_q8-explode"])
        off = _run(**kw)
        on = _run(prefetch="double_buffer", **kw)
    finally:
        dist.destroy_process_group()
    _assert_bitwise(off, on)
    assert sum(r.overflowed for r in on._records.records) > 0


def test_prefetch_host_driver_ignores_it():
    """As the reference's: prefetch belongs to the scan driver; the host
    driver runs its rounds unchanged."""
    off = _run(driver="host", rng_impl="device")
    on = _run(driver="host", rng_impl="device", prefetch="double_buffer")
    _assert_bitwise(off, on)


def test_prefetch_refusals():
    with pytest.raises(ValueError, match="unknown prefetch mode"):
        _run(prefetch="triple_buffer")
    with pytest.raises(SystemExit):
        parse_args(["--prefetch", "triple_buffer"])
    assert parse_args(["--prefetch", "double_buffer"]).prefetch == \
        "double_buffer"
