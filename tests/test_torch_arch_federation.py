"""The architectures this slice ports (the dense configs, the MoE configs
and the jamba hybrid) as every client's local step of the packed round,
through ``FedSAEServer`` and ``fl_train --model <id>``, on the CPU.

The host rounds hold the port against the reference's server on the same
LM federation, init and minibatch draws (``test_torch_lm_federation.py``'s
harness: the float32 smoke step, 1e-4); the scan driver is bitwise the
host driver with ``rng_impl="device"`` for a MoE LM and for the hybrid
(every lane walks all its slots masked on both, the MoE routing and
dispatch read nothing on the host); and the CLI resolves each id to its
smoke LM and runs a round.
"""
import numpy as np
import pytest

import torch_shard_worker as worker
from repro_torch.launch import fl_train
from test_torch_lm_federation import (CFG, DS, TEST_ROWS, _assert_matches,
                                      _port, _reference)
from torch_cases import one_torch_thread  # noqa: F401
from torch_shard_cases import assert_same_run

MOE, JAMBA = "granite-moe-1b-a400m", "jamba-1.5-large-398b"
NEW_ARCHS = ("minitron-8b", "granite-8b", "mistral-large-123b", MOE,
             "kimi-k2-1t-a32b", JAMBA)


@pytest.mark.parametrize("arch", [MOE, JAMBA])
def test_host_rounds_match_reference(arch):
    ref = _reference(arch)
    tsrv = _port(ref, arch)
    tsrv.run()
    _assert_matches(tsrv, ref, 1e-4)


@pytest.mark.parametrize("arch", [MOE, JAMBA])
def test_scan_bitwise_host_with_device_rng(arch):
    case = {"ds": dict(DS, test_rows=TEST_ROWS), "lm": (arch, "float32"),
            "cfg": dict(CFG)}
    host = worker.run_case(dict(case, cfg=dict(CFG, rng_impl="device")))
    scan = worker.run_case(dict(case, cfg=dict(CFG, driver="scan",
                                                 block_size=2)))
    for run in (host, scan):            # the scan evaluates at block ends
        for k in ("acc", "test_loss"):
            run["history"].pop(k)
    assert_same_run(scan, host)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_arch_id_resolves(arch):
    """``fl_train --dataset sent140 --model <id>`` builds the server with
    the arch's smoke LM (its default bfloat16 config) as the step."""
    args = fl_train.parse_args(["--dataset", "sent140", "--model", arch,
                                "--device", "cpu"])
    srv = fl_train.build_server(args)
    assert srv.model.kind == "lm" and srv.model.name == f"model:{arch}"
    assert srv.cfg.lr == 5e-3


def test_cli_moe_arch_id_runs(capsys):
    """The CLI's round with the MoE smoke LM (a round of the reduced
    Sent140's ten lanes in bfloat16 on the CPU costs ~8-27 s an arch, so
    one arch runs it here; ``chip_smoke.py`` runs every id's)."""
    hist = fl_train.main(["--dataset", "sent140", "--model", MOE,
                          "--device", "cpu", "--rounds", "1", "--quiet"])
    assert len(hist["acc"]) == 1 and np.isfinite(hist["train_loss"]).all()
    assert "final: acc=" in capsys.readouterr().out
