"""Smoke of every architecture id on the port: train loss, prefill and one
decode step at each id's smoke config, on the card unless ``--device cpu``
(the twin of ``scripts/smoke_models.py``).

    PYTHONPATH=src python scripts/smoke_models_torch.py [--device cpu]
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.api import VLM_FRONTEND_DIM, build_model  # noqa
from repro_torch.models.encdec import FRONTEND_DIM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

B, S = 2, 64


def make_batch(cfg, gen, dev):
    ints = lambda n: torch.randint(0, cfg.vocab_size, (B, n), generator=gen,
                                   device=dev, dtype=torch.int32)
    if cfg.is_encoder_decoder:
        T = min(cfg.max_decoder_len, S)
        return {"frames": torch.randn((B, S, FRONTEND_DIM), generator=gen,
                                      device=dev),
                "tokens": ints(T), "labels": ints(T)}
    P = min(cfg.n_patches, S // 4) if cfg.n_patches else 0
    batch = {"tokens": ints(S - P), "labels": ints(S - P)}
    if P:
        batch["patches"] = torch.randn((B, P, VLM_FRONTEND_DIM),
                                       generator=gen, device=dev)
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        params = model.init(torch.Generator(dev).manual_seed(1))
        batch = make_batch(cfg, torch.Generator(dev).manual_seed(0), dev)
        loss, _ = model.train_loss(params, batch)
        assert torch.isfinite(loss), (arch, loss)
        with torch.inference_mode():
            pre = {k: v for k, v in batch.items() if k != "labels"}
            logits, _ = model.prefill(params, pre)
            assert torch.isfinite(logits).all(), arch
            cache = model.init_cache(B, S, dev)
            tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
            logits2, _ = model.decode_step(params, cache, tok, 5)
            assert torch.isfinite(logits2).all(), arch
        n_params = sum(x.numel() for x in tree_leaves(params))
        print(f"OK {arch:25s} loss={float(loss):.3f} params={n_params:,}")
    print("ALL OK")


if __name__ == "__main__":
    main()
