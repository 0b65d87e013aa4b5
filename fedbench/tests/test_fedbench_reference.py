"""The plain references agree with the port at a tiny size on the CPU,
run through the cells' own drivers."""
import pytest

from fedbench.tests import helpers


@pytest.mark.parametrize("sampling", ["iid", "shuffle"])
def test_fedsae_reference_follows_the_scan_driver(sampling):
    o = helpers.run(helpers.tiny_fl(sampling))
    r = o.readings
    assert r["plan_mismatches"] == 0
    for k in ("train_loss_gap", "test_loss_gap", "first_update_gap",
              "change_gap"):
        assert r[k] < 1e-5, (k, r[k])
    assert o.attempted >= 4 and o.failed == 0


def test_mamba_reference_follows_the_silo_path():
    o = helpers.run(helpers.tiny_silo("float32"))
    r = o.readings
    assert r["plan_mismatches"] == 0
    for k in ("first_loss_gap", "first_update_median_gap",
              "change_median_gap", "first_update_kind_gap",
              "change_kind_gap", "first_update_worst_gap",
              "change_worst_gap"):
        assert r[k] < 1e-4, (k, r[k])
    assert o.counters["steps"] > 0


def test_chunked_scan_is_the_recurrence():
    import torch
    from fedbench.reference.mamba_lm import selective_scan
    g = torch.Generator().manual_seed(0)
    S, d, N = 256, 8, 4
    dt = torch.rand(S, d, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(d, N, generator=g, dtype=torch.float64) * 3
    B, C = (torch.randn(S, N, generator=g, dtype=torch.float64)
            for _ in range(2))
    x = torch.randn(S, d, generator=g, dtype=torch.float64)
    h, ys = torch.zeros(d, N, dtype=torch.float64), []
    for t in range(S):
        h = torch.exp(dt[t, :, None] * A) * h + (dt[t] * x[t])[:, None] * B[t]
        ys.append(h @ C[t])
    y = selective_scan(dt, A, B, C, x, chunk=64)
    assert torch.allclose(y, torch.stack(ys), rtol=1e-12, atol=1e-12)


def test_emulated_precisions_round_as_stated():
    import torch
    from fedbench.reference.precision import (bf16_round, fp8_round,
                                              operand, tf32_round)
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.0])
    assert tf32_round(x).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]
    y = fp8_round(torch.tensor([448.0, 1.0, 0.3]))
    assert y.tolist()[:2] == [448.0, 1.0] and abs(y[2] - 0.3) < 0.02
    z = bf16_round(torch.tensor([1.0 + 2 ** -9, 1.0 + 3 * 2 ** -8]))
    assert z.tolist() == [1.0, 1.0 + 2 ** -6]
    a = torch.randn(64, requires_grad=True)
    operand(a, "fp8").sum().backward()
    assert torch.equal(a.grad, torch.ones(64))
