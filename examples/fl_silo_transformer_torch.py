"""Cross-silo FedSAE over a production architecture on the port: four
silos fine-tune a (smoke-scale) granite-MoE model; the server predicts
each silo's affordable local-step budget with FedSAE-Ira and aggregates
sample-weighted uploads, with the upload screen on (``screen_norm``).  On
the card unless ``--device cpu`` (the twin of
``examples/fl_silo_transformer.py``).

    PYTHONPATH=src python examples/fl_silo_transformer_torch.py
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.silo import SiloFedSAE  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    fed = SiloFedSAE(build_model(cfg), n_silos=4, lr=5e-3, max_steps=8,
                     screen_norm=1e4, device=args.device)
    ri = np.random.default_rng(0)
    K, S = 4, 64
    sizes = np.asarray(ri.integers(100, 1000, K))
    for r in range(args.rounds):
        # each silo's corpus uses a different vocabulary slice (non-IID)
        toks = np.stack([
            ri.integers(0, cfg.vocab_size // (1 + (k % 3)),
                        (fed.max_steps, 2, S)) for k in range(K)]).astype(
            np.int32)
        stats = fed.run_round({"tokens": toks, "labels": toks}, sizes)
        print(f"round {r}: loss={stats['loss'][-1]:.4f} "
              f"dropout={stats['dropout'][-1]:.2f} "
              f"predicted-pair=({fed.L.mean():.1f},{fed.H.mean():.1f})")
    assert np.isfinite(stats["loss"][-1])
    print("cross-silo FedSAE over", cfg.name, "done")


if __name__ == "__main__":
    main()
