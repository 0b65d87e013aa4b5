"""FedAvg, FedSAE-Ira and FedSAE-Fassa for 30 rounds each on a small
FEMNIST-like federation with MCLR, on the card unless ``--device cpu``
(the twin of ``scripts/smoke_fl.py``).

    PYTHONPATH=src python scripts/smoke_fl_torch.py [--device cpu]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.heterogeneity import HeterogeneitySim  # noqa: E402
from repro_torch.core.server import FedSAEServer, ServerConfig  # noqa: E402
from repro_torch.data.federated import make_femnist_like  # noqa: E402
from repro_torch.models.fl_models import make_mclr  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ds = make_femnist_like(n_clients=60, total=4000, dim=64, max_size=120)
    model = make_mclr(64, ds.n_classes)
    for algo in ("fedavg", "ira", "fassa"):
        t0 = time.time()
        cfg = ServerConfig(algo=algo, n_selected=10, rounds=30, h_cap=20.0,
                           eval_every=5, device=args.device)
        srv = FedSAEServer(ds, model, cfg,
                           het=HeterogeneitySim(ds.n_clients, seed=0))
        h = srv.run(verbose=False)
        assert np.isfinite(h["acc"][-1]), algo
        print(f"{algo:8s} acc={h['acc'][-1]:.3f} "
              f"dropout={np.nanmean(h['dropout']):.2f} "
              f"dropped={np.sum(h['dropped']):.0f} "
              f"overflowed={np.sum(h['overflowed']):.0f} "
              f"uploaded={np.nanmean(h['uploaded']):.1f} "
              f"({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
