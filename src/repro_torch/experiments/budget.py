"""Count the local steps the experiments' runs walk, without training.

    PYTHONPATH=src python -m repro_torch.experiments.budget [R2 Rf Rr]

Each host-driver round's plain shuffle loop walks as many steps as the
cohort's longest budget, and the budgets come from the host algebra alone
(the heterogeneity draws, random selection, Ira / Fassa / the baselines'
workloads), which does not depend on the device or on the trained
params.  This script runs that algebra on the CPU for every run of
``chip_smoke.py``'s ``experiments_phase`` at the cuts given (Table II at
paper scale ``R2`` rounds a run, Figs. 1, 5, 7 and 8 at reduced scale
``Rf``, the paper-scale recipe ``Rr``; defaults 2 5 40, the phase's) and
prints each group's steps and rounds, which size the phase's time on the
card.  AL selection reads the trained values, so Fig. 8's runs and the
recipe are counted with random selection throughout (their budgets
follow the same draws; only the cohorts differ).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.experiments import (common, fig6_table2_main,
                                     fig7_fassa_params, fig8_table3_al)


def longest_budgets(ds, model, algo, rounds, name, **kw):
    """Each round's longest budget (local steps) of one run."""
    srv, _ = common.make_server(ds, model, algo, rounds, name, device="cpu",
                                **kw)
    out = []
    for t in range(rounds):
        E_all, ids = srv._draw_round_inputs(t)
        e_eff = srv._workloads(ids, E_all[ids])[0]
        n = np.minimum(srv.sizes[ids], srv.max_n)
        n_iters = np.minimum(np.round(e_eff * np.ceil(n / srv.cfg.batch_size)),
                             srv.max_iters)
        out.append(int(n_iters.max()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cuts", type=int, nargs="*", default=[2, 5, 40],
                    help="R2 Rf Rr")
    R2, Rf, Rr = ap.parse_args(argv).cuts
    groups = {}
    for dsn in fig6_table2_main.DATASETS:
        ds, model = common.build_dataset(dsn, "paper")
        for algo in fig6_table2_main.ALGOS:
            groups.setdefault(f"table2 {dsn}", []).extend(
                longest_budgets(ds, model, algo, R2, dsn))
    for dsn in ("femnist", "mnist"):
        ds, model = common.build_dataset(dsn, "reduced")
        for E in (10, 12, 15, 20):
            groups.setdefault("fig1", []).extend(longest_budgets(
                ds, model, "fedavg", Rf, dsn, fixed_epochs=float(E)))
        for U in (1.0, 2.0, 3.0, 10.0):
            groups.setdefault("fig5", []).extend(
                longest_budgets(ds, model, "ira", Rf, dsn, U=U))
        for g1, g2, alpha in fig7_fassa_params.GRID:
            groups.setdefault("fig7", []).extend(longest_budgets(
                ds, model, "fassa", Rf, dsn, gamma1=g1, gamma2=g2,
                alpha=alpha))
        for _ in fig8_table3_al.al_grid(Rf):
            groups.setdefault("fig8", []).extend(
                longest_budgets(ds, model, "ira", Rf, dsn))
    ds, model = common.build_dataset("mnist", "paper")
    groups["recipe"] = longest_budgets(ds, model, "fassa", Rr, "mnist")
    for name, steps in groups.items():
        print(f"{name}: {sum(steps)} local steps in {len(steps)} rounds "
              f"(longest round {max(steps)})")


if __name__ == "__main__":
    main()
