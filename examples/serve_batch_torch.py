"""Serve the global model on the port: batched prefill and greedy decode
on the serving path that the decode_32k / long_500k dry-run shapes trace
(a ring-buffer KV cache for sliding-window archs, a constant state for
SSMs), at the arch's smoke size, on the card unless ``--device cpu`` (the
twin of ``examples/serve_batch.py``).

    PYTHONPATH=src python examples/serve_batch_torch.py --arch falcon-mamba-7b
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import generate, prompt_batch  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    out, logits, times = generate(
        model, params, prompt_batch(cfg, args.batch, args.prompt_len, dev),
        args.gen)
    assert torch.isfinite(logits).all()
    rate = args.batch * args.gen / max(times["decode_s"], 1e-9)
    print(f"{args.arch}: generated {args.gen} tokens x batch {args.batch} "
          f"({rate:.1f} tok/s on {dev.type})")
    print("first sequence:", out[0].cpu().numpy())


if __name__ == "__main__":
    main()
