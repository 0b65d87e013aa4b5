"""Paper Fig. 7: FedSAE-Fassa sensitivity to gamma1/gamma2 and the EMA
smoothing alpha (paper picks gamma1=3, gamma2=1, alpha=0.95)."""
from __future__ import annotations

from repro_torch.experiments import common

GRID = [
    # (gamma1, gamma2, alpha)
    (3.0, 1.0, 0.95),   # paper's pick
    (1.0, 1.0, 0.95),   # no stage distinction
    (5.0, 1.0, 0.95),   # very aggressive start
    (3.0, 2.0, 0.95),   # fast arise
    (3.0, 1.0, 0.5),    # short memory
    (3.0, 1.0, 0.99),   # very long memory
]


def run(scale: str = "reduced", rounds=None, device=None, out_dir=None):
    rounds = rounds or common.default_rounds(scale)
    results = []
    for dataset in ("femnist", "mnist"):
        ds, model = common.build_dataset(dataset, scale)
        for g1, g2, alpha in GRID:
            r = common.run_server(ds, model, "fassa", rounds, dataset,
                                  device=device, gamma1=g1, gamma2=g2,
                                  alpha=alpha)
            r.update(gamma1=g1, gamma2=g2, alpha=alpha)
            results.append(r)
            print(f"fig7,{dataset},g1={g1},g2={g2},a={alpha},"
                  f"acc={r['final_acc']:.3f},dropout={r['mean_dropout']:.3f}",
                  flush=True)
    common.save_result("fig7_fassa_params", results, out_dir)
    return results


if __name__ == "__main__":
    args = common.std_argparser(__doc__).parse_args()
    run(args.scale, args.rounds, args.device, args.out_dir)
