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

Every flag of the reference CLI is accepted at its default; a value of a
feature the port does not run yet exits with a usage error naming its
ROADMAP item.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.aggregation import NOT_PORTED as ROBUST_AGGREGATORS
from repro_torch.core.server import (ALGOS, BACKENDS, FedSAEServer,
                                     ServerConfig)
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
                       topk_frac=args.topk_frac, backend=args.backend,
                       upload_screen=args.screen, device=args.device)
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


#: the reference's --faults spellings (fault injection is ROADMAP A9)
FAULT_MODES = ("none", "crash", "nan_upload", "inf_upload",
               "sign_flip_upload", "explode_upload")

#: reference flags the port takes at their default only: dest -> ROADMAP
#: item
NOT_PORTED = dict(
    **dict.fromkeys(("trim_ratio", "agg_weighted", "n_byzantine"), "A6"),
    **dict.fromkeys(("faults", "fault_prob", "fault_seed", "explode_factor",
                     "dropout_prob", "availability", "day_rounds",
                     "duty_cycle", "straggler", "pareto_alpha",
                     "screen_norm_bound", "quarantine_threshold",
                     "quarantine_rounds", "quarantine_min_tries"), "A9"),
    **dict.fromkeys(("metrics_out", "trace_dir"), "A10"),
    **dict.fromkeys(("checkpoint_dir", "checkpoint_every", "resume"),
                    "A11"),
    **dict.fromkeys(("driver", "block_size", "shards", "cohort_capacity",
                     "prefetch"), "A12"))


def parse_capacity(spec: str):
    """--cohort-capacity accepts "full", "auto" or an int lane count (the
    reference's argparse ``type``)."""
    return spec if spec in ("full", "auto") else int(spec)


def make_parser() -> argparse.ArgumentParser:
    """Every flag of the reference CLI, with its default and help, plus
    the port's ``--device``.  Flags of unported features are refused by
    ``parse_args`` unless left at their defaults."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="femnist", choices=list(DATASETS))
    ap.add_argument("--algo", default="ira", choices=ALGOS)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--al-rounds", type=int, default=0)
    ap.add_argument("--aggregator", default="fedavg",
                    choices=("fedavg", "fedprox") + ROBUST_AGGREGATORS,
                    help="fedavg | fedprox; the robust aggregators are "
                         "ROADMAP A6")
    ap.add_argument("--trim-ratio", type=float, default=0.1,
                    help="fraction trimmed per end (trimmed_mean only)")
    ap.add_argument("--agg-weighted", action="store_true",
                    help="robust aggregators weight the surviving uploads "
                         "by client sample counts n_k instead of uniformly")
    ap.add_argument("--n-byzantine", type=int, default=0,
                    help="assumed byzantine uploads (krum / bulyan)")
    ap.add_argument("--selection", default="random",
                    choices=("random", "active", "loss_proportional"),
                    help="cohort selection after the AL warm-up rounds")
    ap.add_argument("--model", default=None,
                    help="local step trained on each client: mclr | mlp "
                         "(lstm is ROADMAP A7, an architecture id over the "
                         "packed federation A13 (iii)).  Default: the "
                         "dataset's, mclr")
    ap.add_argument("--lr", type=float, default=None,
                    help="override the dataset default learning rate")
    ap.add_argument("--sampling", default="shuffle",
                    choices=("shuffle", "iid"),
                    help="local minibatch rule: shuffle is the paper's "
                         "epoch walk; iid runs the fused MCLR / MLP "
                         "local-SGD kernels")
    ap.add_argument("--backend", default="xla",
                    choices=BACKENDS,
                    help="round compute backend; the port runs the same "
                         "code for both: the hand-written kernels on the "
                         "card, their plain versions on the CPU")
    ap.add_argument("--driver", default="host", choices=("host", "scan"),
                    help="round loop driver: host runs one python iteration "
                         "per round; scan (ROADMAP A12) fuses --block-size "
                         "rounds with a single host sync per block")
    ap.add_argument("--block-size", type=int, default=16,
                    help="rounds per fused segment (driver=scan)")
    ap.add_argument("--shards", type=int, default=0,
                    help="shard the client axis over an N-way data mesh "
                         "(0 = replicated)")
    ap.add_argument("--cohort-capacity", default="full",
                    type=parse_capacity,
                    help="per-shard executed cohort lanes (with --shards): "
                         "'full' = masked K-lane parity mode, 'auto' = "
                         "ceil(K/S)*slack capped at K, or an explicit int")
    ap.add_argument("--prefetch", default="off",
                    choices=("off", "double_buffer"),
                    help="scan-driver cohort prefetch: double_buffer "
                         "prepares round t+1 in the same step round t "
                         "trains in")
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
    ap.add_argument("--faults", default="none",
                    choices=FAULT_MODES,
                    help="corrupted-upload fault injection: crash = the "
                         "corrupt client silently dies; *_upload = its "
                         "upload is garbage (NaN/Inf/sign-flipped/"
                         "1e8-amplified delta)")
    ap.add_argument("--fault-prob", type=float, default=0.1,
                    help="per-(client, round) corruption probability")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault schedule (independent of the "
                         "training/selection rng streams)")
    ap.add_argument("--explode-factor", type=float, default=1e8,
                    help="delta amplification for --faults explode_upload")
    ap.add_argument("--dropout-prob", type=float, default=0.0,
                    help="per-(client, round) mid-round crash probability "
                         "(DROPPED outcome; Ira/Fassa halves the task "
                         "pair)")
    ap.add_argument("--availability", default="always",
                    choices=("always", "diurnal"),
                    help="diurnal: each client is on duty for --duty-cycle "
                         "of every --day-rounds rounds, with a seeded "
                         "per-client phase")
    ap.add_argument("--day-rounds", type=int, default=24)
    ap.add_argument("--duty-cycle", type=float, default=0.5)
    ap.add_argument("--straggler", default="none",
                    choices=("none", "pareto"),
                    help="pareto: heavy-tailed per-round slowdowns divide "
                         "the simulated workloads (tail --pareto-alpha)")
    ap.add_argument("--pareto-alpha", type=float, default=2.0)
    ap.add_argument("--screen", default="auto",
                    choices=("auto", "on", "off"),
                    help="server-side upload screen (finite + delta-norm "
                         "check before any aggregator); auto = on whenever "
                         "faults are configured; on is ROADMAP A9")
    ap.add_argument("--screen-norm-bound", type=float, default=1e4,
                    help="max accepted upload delta l2 norm (--screen)")
    ap.add_argument("--quarantine-threshold", type=float, default=0.0,
                    help="> 0: suspend clients whose screened-upload rate "
                         "exceeds this fraction of their attempts for "
                         "--quarantine-rounds rounds")
    ap.add_argument("--quarantine-rounds", type=int, default=16)
    ap.add_argument("--quarantine-min-tries", type=int, default=3)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write atomic whole-server checkpoints into this "
                         "directory")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint cadence in rounds (0 = only with "
                         "--checkpoint-dir at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--checkpoint-dir")
    ap.add_argument("--metrics-out", default=None,
                    help="write per-round telemetry as JSONL RoundRecords "
                         "to this path")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a profiler trace of the run into this "
                         "directory")
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
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the flags; a flag of an unported feature set to anything but
    its default exits through ``ap.error`` naming its ROADMAP item."""
    ap = make_parser()
    args = ap.parse_args(argv)
    for dest, item in NOT_PORTED.items():
        value = getattr(args, dest)
        if value != ap.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            ap.error(f"{flag} {value!r} is not ported yet (ROADMAP {item})")
    if args.aggregator in ROBUST_AGGREGATORS:
        ap.error(f"--aggregator {args.aggregator} is not ported yet "
                 "(ROADMAP A6)")
    if args.screen == "on":
        ap.error("--screen on is not ported yet (ROADMAP A9)")
    if args.model not in (None, "mclr", "mlp"):
        item = "A7" if args.model == "lstm" else "A13 (iii)"
        ap.error(f"--model {args.model} is not ported yet (ROADMAP {item})")
    return args


def main(argv=None):
    args = parse_args(argv)
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
