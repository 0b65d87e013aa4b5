"""A run with the timed path broken underneath comes out not correct,
under each cell's own limits: once for each fault the cell can have (a
round that leaves the model unchanged, half of each batch left out with
the mean over the rest, an answer altered where it is produced), and in
the silo cell a fault confined to the rows of one leaf kind (the scan
backward's dA doubled, which moves only the ``A_log`` rows)."""
import pytest
import torch

from fedbench.reference.compare import judge
from fedbench.tests import helpers


def _keep_global(self, params_k, global_params, weights):
    return {k: (_keep_global(self, params_k[k], v, weights)
                if isinstance(v, dict) else v.clone())
            for k, v in global_params.items()}


def _broken_fl_sgd(original, fault):
    def sgd(x, y, idx, w0, b0, ns, n_iters, **kw):
        if fault == "half_batch":
            half = idx.shape[-1] // 2
            idx = torch.cat([idx[..., :half], idx[..., :half]], -1)
        w, b, losses = original(x, y, idx, w0, b0, ns, n_iters, **kw)
        if fault == "altered":
            w = w.clone()
            w[0].view(-1)[0] += 0.01
            losses = losses.clone()
            losses[0] *= 1.01
        return w, b, losses
    return sgd


def _incorrect(cell, outcome):
    correct, checks = judge(outcome.readings, cell.traffic["limits"])
    return not correct


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fl_cell_catches(fault, monkeypatch):
    from repro_torch.core import aggregation
    from repro_torch.kernels import ops
    cell = helpers.tiny_fl("iid")
    assert not _incorrect(cell, helpers.run(cell))
    if fault == "unchanged":
        monkeypatch.setattr(aggregation.FedAvg, "__call__", _keep_global)
    else:
        monkeypatch.setattr(ops, "fed_local_sgd_mclr", _broken_fl_sgd(
            ops.fed_local_sgd_mclr, fault))
    assert _incorrect(cell, helpers.run(cell))


def _half_tokens(original):
    def xent(h, W, labels):
        losses = original(h, W, labels)
        half = losses.shape[0] // 2
        return torch.cat([losses[:half], losses[:half]])
    return xent


def _doubled_dA(original):
    def bwd(*args, **kw):
        ddt, dA, *rest = original(*args, **kw)
        return (ddt, 2 * dA, *rest)
    return bwd


def _altered_loss(original):
    def train(self, *args, **kw):
        return original(self, *args, **kw) * 1.01
    return train


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "one_kind"])
def test_silo_cell_catches(fault, monkeypatch):
    from repro_torch.core import aggregation
    from repro_torch.core.engine import RoundEngine
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss
    cell = helpers.tiny_silo("float32")
    if fault == "unchanged":
        monkeypatch.setattr(aggregation.FedAvg, "__call__", _keep_global)
    elif fault == "half_batch":
        monkeypatch.setattr(ops, "fused_softmax_xent",
                            _half_tokens(ops.fused_softmax_xent))
    elif fault == "one_kind":
        monkeypatch.setattr(ss, "selective_scan_bwd",
                            _doubled_dA(ss.selective_scan_bwd))
    else:
        monkeypatch.setattr(RoundEngine, "_train_in_place",
                            _altered_loss(RoundEngine._train_in_place))
    assert _incorrect(cell, helpers.run(cell))
