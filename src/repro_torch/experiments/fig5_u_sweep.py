"""Paper Fig. 5: sensitivity of FedSAE-Ira to the inverse-ratio parameter U
(paper tries U = 1, 2, 3, 10 and picks 10)."""
from __future__ import annotations

from repro_torch.experiments import common


def run(scale: str = "reduced", rounds=None, device=None, out_dir=None):
    rounds = rounds or common.default_rounds(scale)
    results = []
    for dataset in ("femnist", "mnist"):
        ds, model = common.build_dataset(dataset, scale)
        for U in (1.0, 2.0, 3.0, 10.0):
            r = common.run_server(ds, model, "ira", rounds, dataset,
                                  device=device, U=U)
            r["U"] = U
            results.append(r)
            print(f"fig5,{dataset},U={U},acc={r['final_acc']:.3f},"
                  f"dropout={r['mean_dropout']:.3f}", flush=True)
    common.save_result("fig5_u_sweep", results, out_dir)
    return results


if __name__ == "__main__":
    args = common.std_argparser(__doc__).parse_args()
    run(args.scale, args.rounds, args.device, args.out_dir)
