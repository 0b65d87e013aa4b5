"""Quickstart on the port: FedSAE vs FedAvg on the public API, on the card
unless ``--device cpu`` (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Builds a heterogeneous federated system (per-round Gaussian client budgets,
exactly the paper's simulator), trains multinomial logistic regression on a
FEMNIST-like federated dataset, and shows FedSAE-Ira adapting workloads
while FedAvg's fixed assignment makes ~every client a straggler.

The local model is just a ``ServerConfig`` field: swap ``model="mclr"``
for ``"mlp"`` (or an arch id like ``"llama3.2-3b"`` on a text dataset) and
the same engine — selection, prediction, compression, aggregation —
trains it unchanged.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import FedSAEServer, ServerConfig  # noqa: E402
from repro_torch.core.heterogeneity import HeterogeneitySim  # noqa: E402
from repro_torch.data.federated import make_femnist_like  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ds = make_femnist_like(n_clients=60, total=4500, dim=64, max_size=120)
    hists = {}
    for algo in ("fedavg", "ira"):
        cfg = ServerConfig(algo=algo, rounds=30, n_selected=10, lr=0.03,
                           h_cap=20.0, eval_every=5, model="mclr",
                           device=args.device)
        server = FedSAEServer(ds, cfg=cfg,
                              het=HeterogeneitySim(ds.n_clients, seed=0))
        hist = hists[algo] = server.run()
        print(f"{algo:7s}: accuracy={hist['acc'][-1]:.3f}  "
              f"stragglers={np.nanmean(hist['dropout'])*100:.0f}%  "
              f"avg-uploaded-epochs={np.nanmean(hist['uploaded']):.1f}")
    return hists


if __name__ == "__main__":
    main()
