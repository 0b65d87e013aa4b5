"""Shared plumbing of the paper's experiments: the dataset registry, the
run helper and the JSON output (the twin of the reference's
``benchmarks/common.py``).

``--scale paper`` uses the paper's client counts and 200 rounds;
``reduced`` (the default) shrinks clients and rounds so that the whole
suite runs in minutes while keeping the phenomena.  Every run is
``FedSAEServer`` on the host driver with the reference's defaults
(``sampling="shuffle"``), on the card unless the caller passes
``device="cpu"``.

``make_server`` also passes the server's test seams ``init_params=`` and
``data_draws=`` through, so that a run can replay another run's (or the
reference's) init and minibatch draws; without them the port draws its
own, and its runs differ from the reference's draw by draw.  The
reference's ``host_bytes_per_round`` and ``upload_bytes_per_round`` belong
to its round-engine benchmark and have no twin here.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.heterogeneity import HeterogeneitySim
from repro_torch.core.server import FedSAEServer, ServerConfig
from repro_torch.data.federated import (make_femnist_like, make_mnist_like,
                                        make_sent140_like, make_synthetic)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.fl_models import make_lstm, make_mclr

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "paper_torch")

# learning rates per paper §IV-A (benchmarks/common.py:26-27)
PAPER_LR = {"femnist": 0.03, "mnist": 0.03, "sent140": 0.3, "synthetic": 0.01}
PAPER_K = {"femnist": 10, "mnist": 30, "sent140": 10, "synthetic": 10}


def build_dataset(name: str, scale: str):
    """(dataset, model) of ``name`` at ``scale``: the reference's sizes
    letter for letter, MCLR or (Sent140) the paper's LSTM."""
    if scale == "paper":
        if name == "femnist":
            ds = make_femnist_like()
        elif name == "mnist":
            ds = make_mnist_like()
        elif name == "sent140":
            ds = make_sent140_like()
        else:
            ds = make_synthetic()
    else:
        if name == "femnist":
            ds = make_femnist_like(n_clients=60, total=4500, dim=64,
                                   max_size=120)
        elif name == "mnist":
            # harder stand-in at reduced scale: overlapping clusters so the
            # accuracy headroom between frameworks is visible
            ds = make_mnist_like(n_clients=100, total=7000, dim=64,
                                 max_size=120, sep=0.8, noise=2.2)
        elif name == "sent140":
            ds = make_sent140_like(n_clients=60, total=1800, vocab=300,
                                   max_size=50)
        else:
            ds = make_synthetic(n_clients=40, total=3000, max_size=150)
    if name == "sent140":
        model = make_lstm(vocab=int(ds.clients_x[0].max()) + 200
                          if scale != "paper" else 1000)
    else:
        model = make_mclr(ds.clients_x[0].shape[1], ds.n_classes)
    return ds, model


def make_server(ds, model, algo: str, rounds: int, dataset_name: str,
                seed: int = 0, device: DeviceLike = None,
                init_params=None, data_draws: Optional[Callable] = None,
                **kw) -> Tuple[FedSAEServer, Dict]:
    """The server of one run and its config (the reference's defaults,
    updated by ``kw``), not yet run."""
    defaults = dict(
        algo=algo, rounds=rounds,
        n_selected=min(PAPER_K[dataset_name], ds.n_clients),
        lr=PAPER_LR[dataset_name], h_cap=24.0, eval_every=max(1, rounds // 40),
        seed=seed)
    defaults.update(kw)
    dev = resolve_device(device)
    cfg = ServerConfig(device=str(dev), **defaults)
    srv = FedSAEServer(ds, model, cfg,
                       het=HeterogeneitySim(ds.n_clients, seed=seed),
                       init_params=init_params, data_draws=data_draws)
    return srv, defaults


def run_made(srv: FedSAEServer, config: Dict, dataset_name: str) -> Dict:
    """Run a ``make_server`` server; the reference's payload: final
    accuracy (the best of the last five recorded), mean and late dropout,
    wall seconds, the history with NaN as None, the config."""
    rounds = config["rounds"]
    t0 = time.time()
    hist = srv.run()
    return {
        "algo": config["algo"], "dataset": dataset_name, "rounds": rounds,
        "final_acc": float(np.nanmax(hist["acc"][-5:])),
        "mean_dropout": float(np.nanmean(hist["dropout"])),
        "late_dropout": float(np.nanmean(hist["dropout"][rounds // 2:])),
        "wall_s": round(time.time() - t0, 1),
        "history": {k: [None if (isinstance(v, float) and np.isnan(v)) else v
                        for v in vals] for k, vals in hist.items()},
        "config": dict(config),
    }


def run_server(ds, model, algo: str, rounds: int, dataset_name: str,
               seed: int = 0, device: DeviceLike = None, **kw) -> Dict:
    """One run with the reference's defaults; returns its payload."""
    srv, config = make_server(ds, model, algo, rounds, dataset_name,
                              seed=seed, device=device, **kw)
    return run_made(srv, config, dataset_name)


def save_result(name: str, payload, out_dir: Optional[str] = None) -> str:
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return path


def std_argparser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--scale", choices=("reduced", "paper"), default="reduced")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir", default=OUT_DIR)
    return ap


def default_rounds(scale: str) -> int:
    return 200 if scale == "paper" else 40
