"""The paper's experiments on the port: one module per table or figure.

  PYTHONPATH=src python -m repro_torch.experiments.run                # reduced
  PYTHONPATH=src python -m repro_torch.experiments.run --scale paper
  PYTHONPATH=src python -m repro_torch.experiments.run --only fig6
  PYTHONPATH=src python -m repro_torch.experiments.run --device cpu --rounds 2

Prints one CSV line per measurement and writes the JSON of each suite to
``experiments/paper_torch/`` (``--out-dir`` elsewhere).  Runs on the card
unless ``--device cpu``; with no card and no ``--device cpu`` it raises.
The reference's runner also runs ``bench_kernels`` and
``roofline_summary``, which are benchmark work: the port's kernels are
held and timed by ``chip_smoke.py`` (phase 2) and its roofline table is
``python -m repro_torch.roofline.report``, so this runner leaves them out.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.experiments import (common, fig1_motivation, fig5_u_sweep,
                                     fig6_table2_main, fig7_fassa_params,
                                     fig8_table3_al)

SUITES = (
    ("fig1_motivation", fig1_motivation.run),
    ("fig5_u_sweep", fig5_u_sweep.run),
    ("fig6_table2_main", fig6_table2_main.run),
    ("fig7_fassa_params", fig7_fassa_params.run),
    ("fig8_table3_al", fig8_table3_al.run),
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=("reduced", "paper"),
                    default="reduced")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--only", default=None,
                    help="substring filter, e.g. fig6")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir", default=common.OUT_DIR)
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    t0 = time.time()
    for name, fn in SUITES:
        if args.only and args.only not in name:
            continue
        print(f"== {name} ==", flush=True)
        fn(args.scale, args.rounds, dev, args.out_dir)
    print(f"experiments done in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
