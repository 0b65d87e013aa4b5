"""The reference's end-to-end behaviour claims (``tests/test_system.py``)
on the port, on the CPU, with the port's own draws (its torch init and
minibatch draws; the heterogeneity and selection draws are the
reference's numpy streams) at the reference's sizes and rounds."""
import numpy as np
import pytest

from repro_torch.core.heterogeneity import HeterogeneitySim
from repro_torch.core.server import FedSAEServer, ServerConfig
from repro_torch.data.federated import make_femnist_like, make_synthetic
from repro_torch.models.fl_models import make_mclr
from torch_cases import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def femnist_small():
    ds = make_femnist_like(n_clients=60, total=4000, dim=64, max_size=120)
    return ds, make_mclr(64, ds.n_classes)


@pytest.fixture(scope="module")
def runs(femnist_small):
    """Each (algo, rounds, al_rounds) run once for the module."""
    ds, model = femnist_small
    cache = {}

    def get(algo, rounds=25, al_rounds=0):
        key = (algo, rounds, al_rounds)
        if key not in cache:
            cache[key] = _run(ds, model, algo, rounds, al_rounds=al_rounds)
        return cache[key]

    return get


def _run(ds, model, algo, rounds=25, **kw):
    cfg = ServerConfig(algo=algo, n_selected=10, rounds=rounds, h_cap=20.0,
                       eval_every=5, device="cpu", **kw)
    srv = FedSAEServer(ds, model, cfg,
                       het=HeterogeneitySim(ds.n_clients, seed=0))
    return srv.run()


def test_fedavg_straggles_under_heterogeneity(runs):
    """Motivation (Fig. 1): fixed E=15 drops ~all clients."""
    assert np.nanmean(runs("fedavg")["dropout"]) > 0.8


@pytest.mark.parametrize("algo", ["ira", "fassa"])
def test_fedsae_beats_fedavg(runs, algo):
    """Table II: FedSAE-Ira and -Fassa improve accuracy and cut
    stragglers."""
    h_avg, h = runs("fedavg"), runs(algo)
    assert h["acc"][-1] > h_avg["acc"][-1] + 0.1
    assert np.nanmean(h["dropout"]) < 0.5 * np.nanmean(h_avg["dropout"])


def test_fassa_mitigates_stragglers_at_least_as_well_as_ira(runs):
    """Paper: Fassa reduces stragglers more than Ira (uses full history);
    the reference's slack of 0.05 for reduced-scale noise."""
    h_ira, h_fassa = runs("ira", 40), runs("fassa", 40)
    assert np.nanmean(h_fassa["dropout"]) <= \
        np.nanmean(h_ira["dropout"]) + 0.05


def test_al_accelerates_early_convergence(runs):
    """Fig. 8 / Table III: AL selection speeds up early training (the
    area under the evaluated accuracy, the reference's slack 0.3)."""
    h_plain, h_al = runs("ira", 20), runs("ira", 20, 20)
    assert np.nansum(h_al["acc"]) >= np.nansum(h_plain["acc"]) - 0.3


def test_workloads_adapt_to_capacity(femnist_small):
    """Assigned workloads climb from the (1, 2) init toward capacity."""
    ds, model = femnist_small
    cfg = ServerConfig(algo="ira", n_selected=10, rounds=30, h_cap=20.0,
                       device="cpu")
    srv = FedSAEServer(ds, model, cfg,
                       het=HeterogeneitySim(ds.n_clients, seed=0))
    srv.run()
    assert srv.H.mean() > 3.0
    assert (srv.L <= srv.H).all()


def test_synthetic_dataset_e2e():
    """Synthetic(1,1): the paper's biggest win (+58% acc), directionally."""
    ds = make_synthetic(n_clients=40, total=3000, max_size=150)
    model = make_mclr(60, ds.n_classes)
    h_avg = _run(ds, model, "fedavg", rounds=20)
    h_ira = _run(ds, model, "ira", rounds=20)
    assert h_ira["acc"][-1] > h_avg["acc"][-1]
