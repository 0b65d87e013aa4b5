"""Batched serving driver of the port: prefill a prompt batch, then greedy
decode.

  # full width on the GPU (flash-attention / selective-scan kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --batch 4 --prompt-len 2048 --gen 32

  # the smoke config on the CPU (plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --smoke --device cpu

  # the VLM (patches before the prompt) and the encoder-decoder (frames):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --smoke --device cpu

Prompt batches come from ``np.random.default_rng(0)``, as in the
reference's ``repro.launch.serve``, so both drivers serve the same prompts
(``prompt_batch``).  The weights are random, drawn from a torch generator
seeded with 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.api import VLM_FRONTEND_DIM, build_model
from repro_torch.models.encdec import FRONTEND_DIM


def prompt_batch(cfg, batch: int, prompt_len: int, device=None):
    """The reference driver's prompt batch, drawn in its order from
    ``default_rng(0)``: tokens int32 [batch, prompt_len]; for a VLM the
    first prompt_len - P of them and patches float32 [batch, P,
    VLM_FRONTEND_DIM], P = min(n_patches, prompt_len // 4); for an
    encoder-decoder frames float32 [batch, prompt_len, FRONTEND_DIM] and
    tokens [batch, min(max_decoder_len, prompt_len)]."""
    ri = np.random.default_rng(0)
    ints = lambda n: torch.as_tensor(ri.integers(0, cfg.vocab_size,
                                                 (batch, n)),
                                     dtype=torch.int32, device=device)
    normal = lambda *shape: torch.as_tensor(ri.normal(size=shape),
                                            dtype=torch.float32,
                                            device=device)
    out = {"tokens": ints(prompt_len)}
    if cfg.is_encoder_decoder:
        frames = normal(batch, prompt_len, FRONTEND_DIM)
        out = {"frames": frames,
               "tokens": ints(min(cfg.max_decoder_len, prompt_len))}
    elif cfg.n_patches:
        P = min(cfg.n_patches, prompt_len // 4)
        out["tokens"] = out["tokens"][:, :prompt_len - P]
        out["patches"] = normal(batch, P, VLM_FRONTEND_DIM)
    return out


@torch.inference_mode()
def generate(model, params, batch, gen: int):
    """Prefill ``batch`` (tokens [B, S], and a VLM's patches or an
    encoder-decoder's frames), then ``gen`` greedy decode steps, exactly
    as the reference driver's loop: decode step i writes position ``S +
    i`` with S the prompt's token count.  A decoder's prefill cache holds
    its prefill's slots (a VLM's P patch positions among them, which that
    count leaves out, as the reference's does), so each step writes slot
    min(S + i, slots - 1) (``layers.attn_decode``); an encoder-decoder's
    holds ``max_decoder_len``.

    Returns (generated [B, gen + 1] int32: the prefill's argmax and one
    token per step, the last step's logits [B, V], {"prefill_s",
    "decode_s"}: host wall times that end in a device sync)."""
    tokens = batch["tokens"]
    sync = (torch.cuda.synchronize if tokens.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch)
    sync()
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out = [tok]
    cur = tokens.shape[1]
    t0 = time.perf_counter()
    for i in range(gen):
        logits, cache = model.decode_step(params, cache, tok, cur + i)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok)
    sync()
    return (torch.cat(out, dim=1), logits,
            {"prefill_s": t_prefill, "decode_s": time.perf_counter() - t0})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    B, S = args.batch, args.prompt_len
    gen, logits, times = generate(model, params,
                                  prompt_batch(cfg, B, S, dev), args.gen)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    print(f"prefill: {B}x{S} in {times['prefill_s'] * 1e3:.0f}ms")
    dt = times["decode_s"]
    rate = B * args.gen / dt if dt > 0 else float("inf")
    print(f"decode: {args.gen} steps x batch {B} in {dt * 1e3:.0f}ms "
          f"({rate:.1f} tok/s); sample: {gen[0, :12].cpu().numpy()}")
    return gen


if __name__ == "__main__":
    main()
