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

  # Sent140 with the paper's LSTM, aggregated by Krum:
  PYTHONPATH=src python -m repro_torch.launch.fl_train --dataset sent140 \
      --aggregator krum --n-byzantine 1

  # cross-silo FedSAE over a production architecture (its smoke config):
  PYTHONPATH=src python -m repro_torch.launch.fl_train \
      --silo-arch llama3.2-3b --silos 4 --rounds 5

  # per-round telemetry as JSONL RoundRecords and a chrome trace of the
  # run, then the health report:
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \
      --rounds 5 --metrics-out run.jsonl --trace-dir trace/
  PYTHONPATH=src python -m repro_torch.launch.fl_report run.jsonl

  # the scan driver: blocks of 16 rounds, one host sync a block (on the
  # card each round is one CUDA-graph replay); with quarantine of the
  # clients whose uploads the screen keeps rejecting:
  PYTHONPATH=src python -m repro_torch.launch.fl_train --dataset femnist \
      --paper-scale --sampling iid --rounds 64 --driver scan --block-size 16
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \
      --driver scan --block-size 4 --faults nan_upload --fault-prob 0.3 \
      --quarantine-threshold 0.3

  # NaN uploads from 30% of the clients, caught by the upload screen, with
  # a checkpoint every 2 rounds; then resume the run from the latest:
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \
      --rounds 6 --faults nan_upload --fault-prob 0.3 \
      --checkpoint-dir ckpt/ --checkpoint-every 2 --metrics-out run.jsonl
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \
      --rounds 10 --faults nan_upload --fault-prob 0.3 \
      --checkpoint-dir ckpt/ --resume --metrics-out run.jsonl

  # client-axis sharding: 2 gloo ranks on the CPU, spawned by the CLI
  # itself, each holding half the clients, each rank's cohort slots
  # compacted to 4 lanes; on the card one rank a card over NCCL
  # (--device cuda --shards 2 needs two cards), or under torchrun:
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \
      --shards 2 --cohort-capacity 4 --rounds 4
  PYTHONPATH=src torchrun --nproc-per-node 2 -m \
      repro_torch.launch.fl_train --shards 2 --driver scan --sampling iid

  # --prefetch double_buffer is accepted (refused on a sharded scan, as
  # the reference refuses it) and runs the off program, the same bits

  # a real decoder as every client's local step (the smoke config of the
  # architecture, a causal LM over the clients' tokens, lr 5e-3), on the
  # scan driver, sharded over two gloo ranks, uploads compressed:
  PYTHONPATH=src python -m repro_torch.launch.fl_train --device cpu \
      --dataset sent140 --model llama3.2-3b --driver scan --shards 2 \
      --compress topk_q8

Every flag of the reference CLI is accepted.  With ``--shards S`` only
rank 0 writes: the progress lines, the final line, ``--metrics-out``,
``--trace-dir`` and the checkpoints.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

from repro_torch.core.aggregation import AGGREGATORS
from repro_torch.core.server import (ALGOS, BACKENDS, CommConfig,
                                     ComputeConfig, FedSAEServer,
                                     RobustnessConfig, ServerConfig)
from repro_torch.data.federated import DATASETS
from repro_torch.faults import FaultModel
from repro_torch.models.fl_models import LOCAL_STEPS
from repro_torch.obs import JsonlSink, trace_if

#: the reference CLI's reduced (non --paper-scale) dataset sizes
REDUCED = {
    "mnist": dict(n_clients=100, total=7000, dim=64, max_size=120),
    "femnist": dict(n_clients=60, total=4500, dim=64, max_size=120),
    "synthetic": dict(n_clients=40, total=3000, max_size=150),
    "sent140": dict(n_clients=60, total=3000, vocab=300, max_size=100),
}


#: the reference CLI's learning rate per dataset (0.03 for the others)
DEFAULT_LR = {"synthetic": 0.01, "sent140": 0.3}
#: ... and for an architecture id as the local step
LM_LR = 5e-3


def make_sink(args, resume_round=None, **meta):
    """--metrics-out -> a JsonlSink whose ``_meta`` header holds the
    reference's keys (``rounds``, ``driver``, ``backend`` and ``meta``);
    None without the flag (no sink: telemetry stays off).

    On --resume (``resume_round``, the checkpoint's next round) an
    existing trace is cut to the rounds before the checkpoint (the
    resumed run emits everything from there again) and reopened in
    append mode, keeping the original header line.
    """
    if not args.metrics_out:
        return None
    append = False
    if resume_round is not None and os.path.exists(args.metrics_out):
        with open(args.metrics_out) as f:
            lines = [ln for ln in f if ln.strip()]
        kept = [ln for ln in lines
                if "_meta" in (row := json.loads(ln))
                or row.get("round", 0) < resume_round]
        with open(args.metrics_out, "w") as f:
            f.writelines(kept)
        append = True
    return JsonlSink(args.metrics_out, meta=dict(
        rounds=args.rounds, driver=args.driver, backend=args.backend,
        **meta), append=append)


def build_faults(args):
    """The CLI's fault axes -> a FaultModel (None when everything is off,
    so a fault-free run is the plain program)."""
    corrupt = FAULT_MODES[args.faults]
    if (corrupt == "none" and args.dropout_prob <= 0
            and args.availability == "always" and args.straggler == "none"):
        return None
    return FaultModel(seed=args.fault_seed, availability=args.availability,
                      day_rounds=args.day_rounds,
                      duty_cycle=args.duty_cycle, straggler=args.straggler,
                      pareto_alpha=args.pareto_alpha,
                      dropout_prob=args.dropout_prob, corrupt=corrupt,
                      corrupt_prob=args.fault_prob,
                      explode_factor=args.explode_factor)


def resume_from(args):
    """--resume: the next round of the latest checkpoint under
    --checkpoint-dir (None without --resume)."""
    if not args.resume:
        return None
    from repro_torch.checkpoint import list_checkpoints
    if not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    ckpts = list_checkpoints(args.checkpoint_dir)
    if not ckpts:
        raise SystemExit(f"--resume: no ckpt_*.pt under "
                         f"{args.checkpoint_dir!r}")
    return ckpts[-1][0]


def build_server(args, sink=None, telemetry=None) -> FedSAEServer:
    make = DATASETS[args.dataset]
    ds = make() if args.paper_scale else make(**REDUCED[args.dataset])
    # a real architecture (--model <arch id>) trains the causal LM and
    # needs a small step, as in the reference CLI
    lr = (args.lr if args.lr is not None
          else LM_LR if args.model not in (None,) + LOCAL_STEPS
          else DEFAULT_LR.get(args.dataset, 0.03))
    cfg = ServerConfig(algo=args.algo, rounds=args.rounds, lr=lr,
                       n_selected=min(10, ds.n_clients),
                       al_rounds=args.al_rounds, h_cap=24.0,
                       aggregator=args.aggregator,
                       trim_ratio=args.trim_ratio,
                       agg_weighted=args.agg_weighted,
                       n_byzantine=args.n_byzantine,
                       selection=args.selection,
                       sampling=args.sampling, model=args.model,
                       device=args.device,
                       compute=ComputeConfig(
                           backend=args.backend,
                           driver=args.driver,
                           block_size=args.block_size,
                           mesh_shards=args.shards,
                           cohort_capacity=args.cohort_capacity,
                           prefetch=args.prefetch),
                       comm=CommConfig(
                           upload_compress=args.compress,
                           topk_frac=args.topk_frac),
                       robustness=RobustnessConfig(
                           faults=build_faults(args),
                           upload_screen=args.screen,
                           screen_norm_bound=args.screen_norm_bound,
                           quarantine_threshold=args.quarantine_threshold,
                           quarantine_rounds=args.quarantine_rounds,
                           quarantine_min_tries=args.quarantine_min_tries))
    return FedSAEServer(ds, cfg=cfg, sink=sink, telemetry=telemetry)


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
    labels are the tokens themselves (the reference's batches).  A VLM
    trains on these tokens alone (its ``modality_proj`` gets a zero
    gradient); an encoder-decoder raises, since its batches need
    frames."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.silo import SiloFedSAE
    from repro_torch.models.api import build_model

    acfg = get_config(args.silo_arch, smoke=True)
    if acfg.is_encoder_decoder:
        raise ValueError(
            f"--silo-arch {args.silo_arch}: the CLI's silo batches carry "
            "tokens only, and an encoder-decoder needs frames (the "
            "reference's CLI fails on them with KeyError: 'frames'); train "
            "it through core.silo.SiloFedSAE with frames in each batch")
    model = build_model(acfg)
    agg_kwargs = ({"trim_ratio": args.trim_ratio}
                  if args.aggregator == "trimmed_mean" else {})
    with make_sink(args, path="silo", arch=args.silo_arch,
                   silos=args.silos) or contextlib.nullcontext() as sink:
        fed = SiloFedSAE(model, args.silos, lr=5e-3,
                         max_steps=args.max_steps,
                         aggregator=args.aggregator, sink=sink,
                         device=args.device, **agg_kwargs)
        ri = np.random.default_rng(0)
        K = args.silos
        sizes = np.asarray(ri.integers(100, 1000, K))
        with trace_if(args.trace_dir):
            for r in range(args.rounds):
                toks = torch.from_numpy(silo_tokens(ri, acfg, K,
                                                    fed.max_steps))
                stats = fed.run_round({"tokens": toks, "labels": toks},
                                      sizes)
                if not args.quiet:
                    print(f"round {r}: loss={stats['loss'][-1]:.4f} "
                          f"dropout={stats['dropout'][-1]:.2f} "
                          f"uploaded_steps="
                          f"{stats['uploaded_steps'][-1]:.1f}")
    if sink is not None:
        print(f"metrics: {sink.path}")
    if not np.isfinite(stats["loss"][-1]):
        raise RuntimeError(f"non-finite silo loss {stats['loss'][-1]}")
    print("silo FL done")
    return fed


#: --faults CLI spellings -> FaultModel corrupt modes
FAULT_MODES = {"none": "none", "crash": "crash", "nan_upload": "nan",
               "inf_upload": "inf", "sign_flip_upload": "sign_flip",
               "explode_upload": "explode"}

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
                    choices=tuple(AGGREGATORS))
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
                    help="local step trained on each client: mclr | mlp | "
                         "lstm | an architecture id (e.g. llama3.2-3b: its "
                         "smoke config as a causal LM on a text dataset). "
                         "Default: lstm for sent140, mclr elsewhere")
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
                         "per round; scan runs --block-size rounds on the "
                         "device with a single host sync per block (on the "
                         "card, one CUDA-graph replay a round)")
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
                    help="scan-driver cohort prefetch (the reference's "
                         "reordering of the same operations; the port "
                         "runs the off program, the same bits)")
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
                    choices=tuple(FAULT_MODES),
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
                         "faults are configured")
    ap.add_argument("--screen-norm-bound", type=float, default=1e4,
                    help="max accepted upload delta l2 norm (--screen)")
    ap.add_argument("--quarantine-threshold", type=float, default=0.0,
                    help="> 0: suspend clients whose screened-upload rate "
                         "exceeds this fraction of their attempts for "
                         "--quarantine-rounds rounds (needs the screen and "
                         "the device rng streams: --driver scan)")
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
    """Parse the flags."""
    return make_parser().parse_args(argv)


def _sharded_main(rank: int, argv):
    """One rank of ``--shards S`` spawned by the CLI: the group exists."""
    return main(argv)


def join_world(args, argv):
    """--shards S: join (or start) the client-axis group.  Returns None
    when this process runs a rank, or rank 0's history after running a
    spawned world whose ranks each run ``main(argv)``.  Under torchrun (``WORLD_SIZE`` set) this process
    joins the group; otherwise the CLI spawns S ranks, one a card over
    NCCL on --device cuda (S cards needed, as the reference's mesh needs
    S devices), S gloo ranks on --device cpu."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh
    if dist.is_initialized():
        return None
    backend = "nccl" if args.device == "cuda" else "gloo"
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if args.shards > have:
            raise SystemExit(
                f"--shards {args.shards} needs {args.shards} CUDA devices "
                f"but only {have} exist (one rank a card); on the CPU run "
                f"--device cpu (gloo)")
    if "WORLD_SIZE" in os.environ:
        import datetime
        local = int(os.environ.get("LOCAL_RANK", 0))
        if backend == "nccl":
            torch.cuda.set_device(local)
        dist.init_process_group(backend, timeout=datetime.timedelta(
            seconds=mesh.GROUP_TIMEOUT_S))
        return None
    results = mesh.spawn_world(_sharded_main, args.shards, backend=backend,
                               device=args.device, args=(argv,))
    return results[0]


def main(argv=None):
    args = parse_args(argv)
    if args.silo_arch:
        return run_silo(args)
    if args.shards:
        hist = join_world(args, list(sys.argv[1:] if argv is None
                                     else argv))
        if hist is not None:
            return hist
    import torch.distributed as dist
    rank = dist.get_rank() if args.shards else 0
    with (make_sink(args, resume_from(args), path="flat",
                    dataset=args.dataset, algo=args.algo, model=args.model)
          if rank == 0 else None) or contextlib.nullcontext() as sink:
        srv = build_server(args, sink,
                           telemetry=bool(args.metrics_out) or None)
        with trace_if(args.trace_dir if rank == 0 else None):
            hist = srv.run(verbose=not args.quiet,
                           checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=args.checkpoint_every,
                           resume=args.resume)
    if rank != 0:
        return hist
    if sink is not None:
        print(f"metrics: {sink.path}")
    # a compacted run reports how many cohort slots it dropped
    ovf = "" if srv.capacity is None else (
        f" overflowed={np.sum(hist['overflowed']):.0f}"
        f"/{len(hist['overflowed']) * srv.cfg.n_selected:.0f} slots"
        f" (capacity={srv.capacity})")
    recs = srv._records.records
    scr = [r.screened for r in recs if r.screened is not None]
    flt = "" if not scr else f" screened={np.sum(scr):.0f} uploads"
    q = [r.quarantined for r in recs if r.quarantined is not None]
    if q:
        flt += f" quarantined={q[-1]:.0f} clients"
    print(f"final: acc={hist['acc'][-1]:.3f} "
          f"mean_dropout={np.nanmean(hist['dropout']):.3f} "
          f"dropped={np.sum(hist['dropped']):.0f}{ovf}{flt}", flush=True)
    return hist


if __name__ == "__main__":
    main()
