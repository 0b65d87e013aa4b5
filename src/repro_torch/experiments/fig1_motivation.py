"""Paper Fig. 1 (motivation): FedAvg with fixed epoch budgets 10/12/15/20
under heterogeneity — accuracy degrades and dropout explodes as E grows."""
from __future__ import annotations

from repro_torch.experiments import common


def run(scale: str = "reduced", rounds=None, device=None, out_dir=None):
    rounds = rounds or common.default_rounds(scale)
    results = []
    for dataset in ("femnist", "mnist"):
        ds, model = common.build_dataset(dataset, scale)
        for E in (10, 12, 15, 20):
            r = common.run_server(ds, model, "fedavg", rounds, dataset,
                                  device=device, fixed_epochs=float(E))
            r["fixed_epochs"] = E
            results.append(r)
            print(f"fig1,{dataset},E={E},acc={r['final_acc']:.3f},"
                  f"dropout={r['mean_dropout']:.3f}", flush=True)
    common.save_result("fig1_motivation", results, out_dir)
    return results


if __name__ == "__main__":
    args = common.std_argparser(__doc__).parse_args()
    run(args.scale, args.rounds, args.device, args.out_dir)
