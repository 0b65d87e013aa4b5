"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference computes, each read against its limit.

Norms are compared leaf by leaf: the gap between the program's norm of a
leaf and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf, so that a leaf that barely moves is not read
against its own rounding.  A leaf whose reference norm is under a
thousandth of the median leaf's moves by round-off alone and is left out.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np

#: a leaf moves by round-off alone below this share of the median leaf
STILL = 1e-3


def moving_leaves(ref_norms: Dict[str, float]) -> List[str]:
    """The leaves whose reference norm is at least ``STILL`` of the
    median leaf's."""
    med = float(np.median(list(ref_norms.values())))
    return [k for k, v in ref_norms.items() if v >= STILL * med]


def worst_leaf_gap(prog_norms: Dict[str, float], ref_norms: Dict[str, float],
                   leaves: Iterable[str]) -> float:
    """max over ``leaves`` of |program norm - reference norm| / max(
    reference norm, median reference norm).  NaN anywhere reads inf."""
    med = float(np.median(list(ref_norms.values())))
    worst = 0.0
    for k in leaves:
        p, r = prog_norms[k], ref_norms[k]
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        worst = max(worst, abs(p - r) / max(r, med, 1e-30))
    return worst


def median_leaf_gap(prog_norms: Dict[str, float],
                    ref_norms: Dict[str, float],
                    leaves: Iterable[str]) -> float:
    """The median over ``leaves`` of the same per-leaf gap as
    ``worst_leaf_gap``: steady from seed to seed where a few small leaves
    carry the rounding noise of sums over many positions."""
    med = float(np.median(list(ref_norms.values())))
    gaps = []
    for k in leaves:
        p, r = prog_norms[k], ref_norms[k]
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        gaps.append(abs(p - r) / max(r, med, 1e-30))
    return float(np.median(gaps))


def kind_gap(prog_norms: Dict[str, float], ref_norms: Dict[str, float],
             leaves: Iterable[str]) -> float:
    """The widest over leaf kinds (a row's name before its first dot:
    every layer's ``A_log`` row is one kind) of the median over the
    kind's rows of |program norm - reference norm| / max(reference norm,
    the kind's median reference norm).  A fault confined to the rows of
    one kind, which are far fewer than half of all rows, moves that
    kind's median where the median over all rows stays put.  NaN anywhere
    reads inf."""
    kinds: Dict[str, List[str]] = {}
    for k in leaves:
        kinds.setdefault(k.split(".")[0], []).append(k)
    worst = 0.0
    for rows in kinds.values():
        med = float(np.median([ref_norms[k] for k in rows]))
        gaps = []
        for k in rows:
            p, r = prog_norms[k], ref_norms[k]
            if not (math.isfinite(p) and math.isfinite(r)):
                return math.inf
            gaps.append(abs(p - r) / max(r, med, 1e-30))
        worst = max(worst, float(np.median(gaps)))
    return worst


def diff(prog, ref) -> float:
    """||prog - ref|| / ||ref|| of two changes (tensors), inf where either
    is not finite."""
    num, den = float((prog - ref).norm()), float(ref.norm())
    if not (math.isfinite(num) and math.isfinite(den)):
        return math.inf
    return num / max(den, 1e-30)


def median_leaf_diff(prog, ref, leaves: Iterable[str]) -> float:
    """The median over ``leaves`` of ``diff``: how far the program's change
    of a leaf lies from the reference's, over the reference's."""
    return float(np.median([diff(prog[k], ref[k]) for k in leaves]))


def rel_gap(prog: float, ref: float) -> float:
    """|prog - ref| / |ref| (inf when either is not finite)."""
    if not (math.isfinite(prog) and math.isfinite(ref)):
        return 0.0 if (math.isnan(prog) and math.isnan(ref)) else math.inf
    return abs(prog - ref) / max(abs(ref), 1e-30)


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Dict]]:
    """(correct, checks): every reading that has a limit at or under it.
    A limit without a reading fails; a reading without one is not
    compared."""
    checks, ok = [], True
    for name in sorted(limits):
        value = readings.get(name, math.nan)
        limit = limits.get(name, math.nan)
        passed = math.isfinite(value) and value <= limit
        ok = ok and passed
        checks.append({"name": name, "value": value, "limit": limit})
    return ok, checks
