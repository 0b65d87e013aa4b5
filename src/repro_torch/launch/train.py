"""Centralized training driver of the port (smoke runs, and the per-silo
local step of cross-silo FL run centrally).

  # the smoke config on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --steps 20 --batch 4 --seq 128 --device cpu

  # on the GPU (flash-attention forward and backward, fused
  # cross-entropy; the selective scan for falcon-mamba-7b):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --steps 5

The flags are the reference's (``repro.launch.train``) plus ``--device``.
Weights are random, drawn from a torch generator seeded with 0; each
batch's tokens come from ``np.random.default_rng`` seeded by a draw of a
torch generator seeded with 1 (the reference seeds it from a threefry
draw, which torch cannot replay).  ``--checkpoint PATH`` writes the
trained params after the last step (``checkpoint.save_checkpoint``:
atomic, read back by ``checkpoint.load_checkpoint``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_leaves


def synth_batch(cfg, gen: torch.Generator, batch: int, seq: int,
                device=None):
    """Random next-token batch {"tokens", "labels"}: int32 [batch, seq]
    each, from numpy seeded by one draw of ``gen``."""
    if cfg.is_encoder_decoder or cfg.n_patches:
        raise ValueError(f"{cfg.name}: synth_batch covers decoder-only "
                         "configs; the VLM prefix and the encoder-decoder "
                         "are ROADMAP A13 (ii) (b) and (c)")
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    ri = np.random.default_rng(seed)
    draw = lambda: torch.as_tensor(ri.integers(0, cfg.vocab_size,
                                               (batch, seq)),
                                   dtype=torch.int32, device=device)
    return {"tokens": draw(), "labels": draw()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw", choices=("sgd", "adamw"))
    ap.add_argument("--checkpoint", default=None,
                    help="write the trained params to this file")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the hand-written kernels; cpu runs "
                         "their plain PyTorch versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={args.arch} smoke={args.smoke} params={n_params:,}")

    opt = adamw(args.lr) if args.optimizer == "adamw" else sgd(args.lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)

    gen = torch.Generator().manual_seed(1)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        batch = synth_batch(cfg, gen, args.batch, args.seq, dev)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")
        if not np.isfinite(losses[-1]):
            raise RuntimeError("loss diverged")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, step=args.steps)
        print(f"checkpoint -> {args.checkpoint}")
    return losses


if __name__ == "__main__":
    main()
