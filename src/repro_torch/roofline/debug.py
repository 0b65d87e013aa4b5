"""Debug view of a traced step: its top collectives and its top
byte-moving ops, the counterpart of ``repro/roofline/debug.py`` (which
reads a compiled HLO dump; the port traces the step instead).

  PYTHONPATH=src python -m repro_torch.roofline.debug --arch llama3.2-3b --shape train_4k
"""
from __future__ import annotations

import argparse


def top_collectives(cost, k: int = 15) -> str:
    """The ``k`` largest collectives of a ``StepCost`` by wire bytes."""
    rows = sorted(cost.collectives, key=lambda c: -c[0])
    lines = [f"total wire bytes/device: {cost.collective_bytes:.3e}"]
    for wire, kind, label, group, link, times in rows[:k]:
        lines.append(f"  {wire:.3e} {kind:15s} x{times:<4.0f} group "
                     f"{group:<4d} {link:8s} {label}")
    return "\n".join(lines)


def top_ops(cost, k: int = 15) -> str:
    """The ``k`` ops of a ``StepCost`` that move the most bytes."""
    rows = sorted(cost.by_op.items(), key=lambda kv: -kv[1][2])
    lines = [f"total bytes/device: {cost.bytes_accessed:.3e}, "
             f"flops/device: {cost.flops:.3e}"]
    for name, (calls, flops, nbytes) in rows[:k]:
        lines.append(f"  {nbytes:.3e} B {flops:.3e} flop x{calls:<6.0f} "
                     f"{name}")
    return "\n".join(lines)


def main():
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import apply_variants, variant_for
    from repro_torch.launch.mesh import make_production_mesh, set_mesh
    from repro_torch.launch.steps import trace_step
    from repro_torch.models.api import build_model
    from repro_torch.sharding.rules import use_rules

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "adamw"))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("-k", type=int, default=15)
    args = ap.parse_args()
    shape = get_shape(args.shape)
    cfg, rules = apply_variants(variant_for(get_config(args.arch), shape),
                                args.variant)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    with set_mesh(mesh), use_rules(rules):
        cost, _, _ = trace_step(build_model(cfg), shape, mesh,
                                args.optimizer)
    print(top_collectives(cost, args.k))
    print(top_ops(cost, args.k))


if __name__ == "__main__":
    main()
