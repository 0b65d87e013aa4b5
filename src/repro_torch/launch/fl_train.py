"""Federated training driver of the port — the paper's system end to end.

  # FEMNIST at the paper's scale on the GPU, fused MCLR local-SGD kernel:
  PYTHONPATH=src python -m repro_torch.launch.fl_train --dataset femnist \
      --paper-scale --sampling iid

  # the MLP with top-k + int8 upload compression (dense local-SGD and
  # compression kernels):
  PYTHONPATH=src python -m repro_torch.launch.fl_train --dataset femnist \
      --paper-scale --model mlp --sampling iid --compress topk_q8

  # reduced scale on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \
      --rounds 3

  # cross-silo FedSAE over a production architecture (its smoke config):
  PYTHONPATH=src python -m repro_torch.launch.fl_train \
      --silo-arch llama3.2-3b --silos 4 --rounds 5
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.server import ALGOS, FedSAEServer, ServerConfig
from repro_torch.data.federated import DATASETS

#: the reference CLI's reduced (non --paper-scale) dataset sizes
REDUCED = {
    "mnist": dict(n_clients=100, total=7000, dim=64, max_size=120),
    "femnist": dict(n_clients=60, total=4500, dim=64, max_size=120),
    "synthetic": dict(n_clients=40, total=3000, max_size=150),
    "sent140": dict(n_clients=60, total=3000, vocab=300, max_size=100),
}


def build_server(args) -> FedSAEServer:
    make = DATASETS[args.dataset]
    ds = make() if args.paper_scale else make(**REDUCED[args.dataset])
    lr = args.lr if args.lr is not None else (
        0.01 if args.dataset == "synthetic" else 0.03)
    cfg = ServerConfig(algo=args.algo, rounds=args.rounds, lr=lr,
                       n_selected=min(10, ds.n_clients),
                       al_rounds=args.al_rounds, h_cap=24.0,
                       aggregator=args.aggregator, selection=args.selection,
                       sampling=args.sampling, model=args.model,
                       upload_compress=args.compress,
                       topk_frac=args.topk_frac, device=args.device)
    return FedSAEServer(ds, cfg=cfg)


def silo_tokens(ri, cfg, K: int, max_steps: int, B: int = 2, S: int = 64):
    """One round's token stream of the reference CLI: [K, max_steps, B, S]
    int32, silo k's tokens uniform in [0, vocab // (1 + k % 3)), so each
    silo has its own token distribution."""
    return np.stack([ri.integers(0, cfg.vocab_size // (1 + (k % 3)),
                                 (max_steps, B, S)) for k in range(K)]
                    ).astype(np.int32)


def run_silo(args):
    """Cross-silo FedSAE (``core.silo.SiloFedSAE``) over the smoke config
    of ``--silo-arch``, with the reference CLI's traffic: sizes in
    [100, 1000) and per-silo token streams from ``default_rng(0)``, whose
    labels are the tokens themselves (the reference's batches)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.silo import SiloFedSAE
    from repro_torch.models.api import build_model

    acfg = get_config(args.silo_arch, smoke=True)
    model = build_model(acfg)
    fed = SiloFedSAE(model, args.silos, lr=5e-3, max_steps=args.max_steps,
                     aggregator=args.aggregator, device=args.device)
    ri = np.random.default_rng(0)
    K = args.silos
    sizes = np.asarray(ri.integers(100, 1000, K))
    for r in range(args.rounds):
        toks = torch.from_numpy(silo_tokens(ri, acfg, K, fed.max_steps))
        stats = fed.run_round({"tokens": toks, "labels": toks}, sizes)
        if not args.quiet:
            print(f"round {r}: loss={stats['loss'][-1]:.4f} "
                  f"dropout={stats['dropout'][-1]:.2f} "
                  f"uploaded_steps={stats['uploaded_steps'][-1]:.1f}")
    if not np.isfinite(stats["loss"][-1]):
        raise RuntimeError(f"non-finite silo loss {stats['loss'][-1]}")
    print("silo FL done")
    return fed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="femnist", choices=list(DATASETS))
    ap.add_argument("--algo", default="ira", choices=ALGOS)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--al-rounds", type=int, default=0)
    ap.add_argument("--aggregator", default="fedavg",
                    choices=("fedavg", "fedprox"))
    ap.add_argument("--selection", default="random",
                    choices=("random", "active", "loss_proportional"),
                    help="cohort selection after the AL warm-up rounds")
    ap.add_argument("--model", default=None, choices=("mclr", "mlp"),
                    help="local step trained on each client (default: the "
                         "dataset's, mclr)")
    ap.add_argument("--sampling", default="shuffle",
                    choices=("shuffle", "iid"),
                    help="local minibatch rule: shuffle is the paper's "
                         "epoch walk; iid runs the fused MCLR / MLP "
                         "local-SGD kernels")
    ap.add_argument("--compress", default="none",
                    choices=("none", "topk_q8"),
                    help="upload transform between local SGD and "
                         "aggregation: topk_q8 ships each client's delta as "
                         "top-k int8 coordinates with a per-client scale "
                         "and carries the quantisation error as an "
                         "error-feedback residual")
    ap.add_argument("--topk-frac", type=float, default=0.1,
                    help="kept coordinate fraction for --compress topk_q8: "
                         "k = ceil(frac * n_params) per client per round")
    ap.add_argument("--lr", type=float, default=None,
                    help="override the dataset default learning rate")
    ap.add_argument("--paper-scale", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the hand-written kernels; cpu runs "
                         "their plain PyTorch versions")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-round progress lines")
    ap.add_argument("--silo-arch", default=None,
                    help="run cross-silo FedSAE over this architecture's "
                         "smoke config instead of the packed federation")
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=8)
    args = ap.parse_args(argv)
    if args.silo_arch:
        return run_silo(args)
    srv = build_server(args)
    hist = srv.run(verbose=not args.quiet)
    print(f"final: acc={hist['acc'][-1]:.3f} "
          f"mean_dropout={np.nanmean(hist['dropout']):.3f} "
          f"dropped={np.sum(hist['dropped']):.0f}")
    return hist


if __name__ == "__main__":
    main()
