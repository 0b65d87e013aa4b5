"""Centralized training driver of the port (smoke runs, and the per-silo
local step of cross-silo FL run centrally).

  # the smoke config on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --steps 20 --batch 4 --seq 128 --device cpu

  # on the GPU (flash-attention forward and backward, fused
  # cross-entropy; the selective scan for falcon-mamba-7b):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --steps 5

  # the VLM (patches before the tokens) and the encoder-decoder (frames):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-2b \
      --smoke --steps 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
      --smoke --steps 5 --device cpu

The flags are the reference's (``repro.launch.train``) plus ``--device``.
Weights are random, drawn from a torch generator seeded with 0; each
batch (tokens, and a VLM's patches or an encoder-decoder's frames) comes
from ``np.random.default_rng`` seeded by a draw of a torch generator
seeded with 1, in the reference's order (``synth_batch_from``; the
reference seeds it from a threefry draw, which torch cannot replay).
``--checkpoint PATH`` writes the trained params after the last step
(``checkpoint.save_checkpoint``: atomic, read back by
``checkpoint.load_checkpoint``).
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
from repro_torch.models.api import VLM_FRONTEND_DIM, build_model
from repro_torch.models.encdec import FRONTEND_DIM
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_leaves


def synth_batch(cfg, gen: torch.Generator, batch: int, seq: int,
                device=None):
    """A random training batch from numpy seeded by one draw of ``gen``
    (``synth_batch_from``)."""
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    return synth_batch_from(cfg, np.random.default_rng(seed), batch, seq,
                            device)


def synth_batch_from(cfg, ri: np.random.Generator, batch: int, seq: int,
                     device=None):
    """The reference's ``synth_batch`` from its numpy generator ``ri``,
    drawn in its order.  Decoder-only: tokens and labels int32 [batch, seq
    - P], and for a VLM (P = min(n_patches, seq // 4) > 0) patches float32
    [batch, P, VLM_FRONTEND_DIM].  Encoder-decoder: frames float32 [batch,
    seq, FRONTEND_DIM], then tokens and labels int32 [batch, min(
    max_decoder_len, seq)]."""
    ints = lambda n: torch.as_tensor(ri.integers(0, cfg.vocab_size,
                                                 (batch, n)),
                                     dtype=torch.int32, device=device)
    normal = lambda *shape: torch.as_tensor(ri.normal(size=shape),
                                            dtype=torch.float32,
                                            device=device)
    if cfg.is_encoder_decoder:
        frames = normal(batch, seq, FRONTEND_DIM)
        T = min(cfg.max_decoder_len, seq)
        return {"frames": frames, "tokens": ints(T), "labels": ints(T)}
    P = min(cfg.n_patches, seq // 4) if cfg.n_patches else 0
    out = {"tokens": ints(seq - P), "labels": ints(seq - P)}
    if P:
        out["patches"] = normal(batch, P, VLM_FRONTEND_DIM)
    return out


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
