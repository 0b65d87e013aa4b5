"""Paper Fig. 6 + Table II (the headline result): FedAvg vs FedSAE-Ira vs
FedSAE-Fassa on all four datasets — accuracy up, stragglers down.
Extra reference points beyond the paper: FedProx (ideal partial work) and
an unrealizable ORACLE that knows each client's affordable workload in
advance (the skyline any predictor is chasing)."""
from __future__ import annotations

import numpy as np

from repro_torch.experiments import common

ALGOS = ("fedavg", "ira", "fassa", "fedprox", "oracle")
DATASETS = ("femnist", "mnist", "sent140", "synthetic")


def summarize(table) -> dict:
    """Per dataset, Ira's and Fassa's accuracy gain and straggler
    reduction over FedAvg, from ``table[(dataset, algo)]`` payloads."""
    summary = {}
    for dataset in DATASETS:
        base = table[(dataset, "fedavg")]
        for algo in ("ira", "fassa"):
            r = table[(dataset, algo)]
            summary[f"{dataset}/{algo}"] = {
                "acc_gain": r["final_acc"] - base["final_acc"],
                "straggler_reduction": base["mean_dropout"]
                - r["mean_dropout"],
            }
    return summary


def run(scale: str = "reduced", rounds=None, device=None, out_dir=None):
    rounds = rounds or common.default_rounds(scale)
    table = {}
    results = []
    for dataset in DATASETS:
        ds, model = common.build_dataset(dataset, scale)
        for algo in ALGOS:
            r = common.run_server(ds, model, algo, rounds, dataset,
                                  device=device)
            results.append(r)
            table[(dataset, algo)] = r
            print(f"table2,{dataset},{algo},acc={r['final_acc']:.3f},"
                  f"stragglers={r['mean_dropout']*100:.1f}%", flush=True)
    # paper-style summary: improvement over FedAvg
    summary = summarize(table)
    gains = [v["acc_gain"] for v in summary.values()]
    reds = [v["straggler_reduction"] for v in summary.values()]
    print(f"table2,AVERAGE,acc_gain={np.mean(gains)*100:.1f}pp,"
          f"straggler_reduction={np.mean(reds)*100:.1f}pp", flush=True)
    common.save_result("fig6_table2_main", {
        "results": results, "summary": summary,
        "avg_acc_gain": float(np.mean(gains)),
        "avg_straggler_reduction": float(np.mean(reds))}, out_dir)
    return results


if __name__ == "__main__":
    args = common.std_argparser(__doc__).parse_args()
    run(args.scale, args.rounds, args.device, args.out_dir)
