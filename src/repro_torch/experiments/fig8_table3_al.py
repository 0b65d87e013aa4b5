"""Paper Fig. 8 + Table III: Active-Learning client selection for the first
n rounds — rounds needed to hit a target accuracy (AL speeds early
convergence; paper recommends AL for the first quarter of training)."""
from __future__ import annotations

import numpy as np

from repro_torch.experiments import common

# paper targets (real MNIST/FEMNIST); reduced-scale stand-ins are easier /
# harder respectively, so use targets sized to their accuracy headroom
TARGET_ACC = {"paper": {"femnist": 0.60, "mnist": 0.84},
              "reduced": {"femnist": 0.90, "mnist": 0.70}}


def rounds_to_target(history, target):
    """The 1-based round at which the accuracy first reaches ``target``
    (None and NaN entries skipped), or None."""
    accs = history["acc"]
    for i, a in enumerate(accs):
        if a is not None and not (isinstance(a, float) and np.isnan(a)) \
                and a >= target:
            return i + 1
    return None


def al_grid(rounds: int):
    return [0, rounds // 10, rounds // 4, rounds // 2, rounds]


def run(scale: str = "reduced", rounds=None, device=None, out_dir=None):
    rounds = rounds or common.default_rounds(scale)
    results = []
    for dataset in ("femnist", "mnist"):
        ds, model = common.build_dataset(dataset, scale)
        target = TARGET_ACC[scale][dataset]
        for al in al_grid(rounds):
            r = common.run_server(ds, model, "ira", rounds, dataset,
                                  device=device, al_rounds=al, eval_every=1)
            r["al_rounds"] = al
            r["rounds_to_target"] = rounds_to_target(r["history"], target)
            results.append(r)
            print(f"table3,{dataset},AL{al},to_{target:.0%}="
                  f"{r['rounds_to_target']},final={r['final_acc']:.3f}",
                  flush=True)
    common.save_result("fig8_table3_al", results, out_dir)
    return results


if __name__ == "__main__":
    args = common.std_argparser(__doc__).parse_args()
    run(args.scale, args.rounds, args.device, args.out_dir)
