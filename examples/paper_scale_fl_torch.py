"""End-to-end driver at the PAPER's scale on the port, on the card unless
``--device cpu`` (the twin of ``examples/paper_scale_fl.py``):
1,000-client MNIST-like federation, K=30 participants/round, a few hundred
rounds of FedSAE-Fassa with AL selection for the first quarter — exactly
the deployment recipe §IV-C recommends.

    PYTHONPATH=src python examples/paper_scale_fl_torch.py   # 200 rounds
    PYTHONPATH=src python examples/paper_scale_fl_torch.py --rounds 60
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.heterogeneity import HeterogeneitySim  # noqa: E402
from repro_torch.core.server import FedSAEServer, ServerConfig  # noqa: E402
from repro_torch.data.federated import make_mnist_like  # noqa: E402
from repro_torch.models.fl_models import make_mclr  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    ds = make_mnist_like(n_clients=args.clients)  # 69,035 samples
    model = make_mclr(ds.clients_x[0].shape[1], ds.n_classes)

    cfg = ServerConfig(
        algo="fassa", rounds=args.rounds, n_selected=30, lr=0.03,
        al_rounds=args.rounds // 4,      # paper: AL for the first quarter
        h_cap=24.0, eval_every=5, device=args.device,
    )
    server = FedSAEServer(ds, model, cfg,
                          het=HeterogeneitySim(ds.n_clients, seed=0))
    hist = server.run(verbose=True)

    acc = hist["acc"][-1]
    drop = np.nanmean(hist["dropout"])
    print("\n=== paper-scale FedSAE-Fassa+AL run ===")
    print(f"clients={ds.n_clients} rounds={args.rounds} "
          f"final_acc={acc:.3f} stragglers={drop*100:.1f}%")
    print("paper reference (real MNIST, Table II): acc 89.4%, "
          "stragglers 0.3%")
    return hist


if __name__ == "__main__":
    main()
