"""Render a recorded run's telemetry JSONL into a straggler/health report,
a copy of the reference's ``repro/obs/report.py`` (the library half of
``python -m repro_torch.launch.fl_report``): for the same meta and records
it renders the same string.

The report is plain markdown (renders fine as text in a terminal or a CI
artifact):

  * round summary — rounds recorded, accuracy first/best/final
  * straggler rate over rounds — windowed rates with an ASCII bar trend,
    plus overflow (capacity-policy) drops when a compacted run recorded any
  * per-client reliability — selected/uploaded/drop-rate table for the
    least reliable clients (needs the telemetry extras ``ids`` +
    ``client_uploaded``; degrades gracefully to a note without them)
  * faults & defenses — screened-upload totals/trend and quarantine
    occupancy when the run carried those counters (omitted otherwise)
  * upload ledger — bytes shipped vs the dense-f32 cost of the same uploads
  * rounds/s trend — from per-round wall times, early vs late windows

All statistics are computed NaN-aware: rounds whose eval was skipped (NaN
test_loss/acc) or crash-only rounds (NaN train_loss) never poison a mean.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.schema import RoundRecord

_BAR = " ▁▂▃▄▅▆▇█"


def _sparkline(values: Sequence[float]) -> str:
    vals = [v for v in values if not math.isnan(v)]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    out = []
    for v in values:
        if math.isnan(v):
            out.append(" ")
        else:
            out.append(_BAR[1 + int((v - lo) / span * (len(_BAR) - 2))])
    return "".join(out)


def _nanmean(xs: Sequence[float]) -> float:
    xs = [x for x in xs if not math.isnan(x)]
    return sum(xs) / len(xs) if xs else float("nan")


def _windows(n: int, k: int = 10) -> List[Tuple[int, int]]:
    """Split [0, n) into up to k near-equal contiguous windows."""
    k = max(1, min(k, n))
    edges = np.linspace(0, n, k + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if b < 1024 or unit == "GiB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{b:.0f} B"
        b /= 1024
    return f"{b:.1f} GiB"


def client_reliability(records: Sequence[RoundRecord]) -> Optional[Dict]:
    """Per-client (selected, uploaded) counts from the telemetry extras;
    None when no record carries them."""
    rows = [(r.ids, r.client_uploaded) for r in records
            if r.ids is not None and r.client_uploaded is not None]
    if not rows:
        return None
    selected: Dict[int, int] = {}
    uploaded: Dict[int, int] = {}
    for ids, up in rows:
        for cid, u in zip(ids, up):
            selected[cid] = selected.get(cid, 0) + 1
            uploaded[cid] = uploaded.get(cid, 0) + int(u)
    return {"selected": selected, "uploaded": uploaded,
            "rounds_covered": len(rows)}


def render_report(meta: Dict, records: List[RoundRecord],
                  top: int = 10) -> str:
    """The markdown health report for one recorded run."""
    lines: List[str] = ["# FedSAE run health report", ""]
    if meta:
        lines.append("| run | |")
        lines.append("|---|---|")
        for k in sorted(meta):
            lines.append(f"| {k} | {meta[k]} |")
        lines.append("")
    if not records:
        lines.append("_No round records._")
        return "\n".join(lines) + "\n"

    n = len(records)
    accs = [r.acc for r in records if not math.isnan(r.acc)]
    lines.append("## Round summary")
    lines.append("")
    lines.append(f"- rounds recorded: **{n}** "
                 f"(rounds {records[0].round}..{records[-1].round})")
    if accs:
        lines.append(f"- accuracy: first {accs[0]:.3f} -> best "
                     f"{max(accs):.3f} -> final {accs[-1]:.3f}")
    tl = _nanmean([r.train_loss for r in records])
    if not math.isnan(tl):
        lines.append(f"- mean train loss: {tl:.3f}")
    lines.append("")

    # ---- straggler rate over rounds ----------------------------------
    lines.append("## Stragglers")
    lines.append("")
    mean_drop = _nanmean([r.dropout for r in records])
    total_dropped = sum(r.dropped for r in records
                        if not math.isnan(r.dropped))
    lines.append(f"- mean straggler (dropout) rate: **{mean_drop:.1%}** "
                 f"({total_dropped:.0f} dropped uploads total)")
    win = _windows(n)
    rates = [_nanmean([records[i].dropout for i in range(a, b)])
             for a, b in win]
    lines.append(f"- rate trend (windowed): `{_sparkline(rates)}`")
    lines.append("")
    lines.append("| rounds | straggler rate | mean uploaded epochs |")
    lines.append("|---|---|---|")
    for (a, b), rate in zip(win, rates):
        up = _nanmean([records[i].uploaded for i in range(a, b)])
        lines.append(f"| {records[a].round}-{records[b - 1].round} "
                     f"| {rate:.1%} | {up:.2f} |")
    lines.append("")
    total_ovf = sum(r.overflowed for r in records
                    if not math.isnan(r.overflowed))
    if total_ovf > 0:
        lines.append(f"- capacity overflow drops: {total_ovf:.0f} cohort "
                     f"slots sacrificed by the per-shard lane budget")
        lines.append("")

    # ---- per-client reliability --------------------------------------
    lines.append("## Per-client reliability")
    lines.append("")
    rel = client_reliability(records)
    if rel is None:
        lines.append("_No per-client telemetry in this run (record with "
                     "metric accumulation enabled, e.g. fl_train "
                     "--metrics-out)._")
        lines.append("")
    else:
        sel, up = rel["selected"], rel["uploaded"]
        rank = sorted(sel, key=lambda c: (up[c] / sel[c], -sel[c]))
        lines.append(f"- distinct clients selected: {len(sel)} over "
                     f"{rel['rounds_covered']} rounds")
        n_flaky = sum(1 for c in sel if up[c] < sel[c])
        lines.append(f"- clients that dropped at least once: {n_flaky}")
        lines.append("")
        lines.append(f"Least reliable {min(top, len(rank))} clients:")
        lines.append("")
        lines.append("| client | selected | uploaded | drop rate |")
        lines.append("|---|---|---|---|")
        for cid in rank[:top]:
            s, u = sel[cid], up[cid]
            lines.append(f"| {cid} | {s} | {u} | {(s - u) / s:.0%} |")
        lines.append("")

    # ---- faults & defenses -------------------------------------------
    # rendered only when the run recorded the hardened-aggregation
    # counters (screened / quarantined are Optional schema fields; traces
    # from fault-free runs simply skip the section)
    scr = [r.screened for r in records if r.screened is not None]
    qua = [r.quarantined for r in records if r.quarantined is not None]
    if scr or qua:
        lines.append("## Faults & defenses")
        lines.append("")
        if scr:
            total_scr = sum(scr)
            hit = sum(1 for s in scr if s > 0)
            lines.append(f"- uploads rejected by the finite/norm screen: "
                         f"**{total_scr:.0f}** across {hit} of {len(scr)} "
                         f"screened rounds")
            srates = [_nanmean([records[i].screened for i in range(a, b)
                                if records[i].screened is not None])
                      for a, b in win]
            lines.append(f"- screened per round (windowed): "
                         f"`{_sparkline(srates)}`")
        if qua:
            peak = max(qua)
            lines.append(f"- reliability quarantine: peak **{peak:.0f}** "
                         f"clients suspended at once, {qua[-1]:.0f} still "
                         f"suspended at the end of the run")
        lines.append("")

    # ---- upload ledger -----------------------------------------------
    lines.append("## Upload ledger")
    lines.append("")
    shipped = [r.upload_bytes for r in records if r.upload_bytes is not None]
    dense = [r.dense_upload_bytes for r in records
             if r.dense_upload_bytes is not None]
    if shipped and dense:
        tot_s, tot_d = sum(shipped), sum(dense)
        lines.append(f"- shipped: {_fmt_bytes(tot_s)} over {len(shipped)} "
                     f"rounds ({_fmt_bytes(tot_s / len(shipped))}/round)")
        lines.append(f"- dense-f32 cost of the same uploads: "
                     f"{_fmt_bytes(tot_d)}")
        if tot_d > 0:
            lines.append(f"- compression saved **{1 - tot_s / tot_d:.1%}** "
                         f"({_fmt_bytes(tot_d - tot_s)})")
    else:
        lines.append("_No byte ledger in this run (telemetry extras "
                     "absent)._")
    lines.append("")

    # ---- rounds/s trend ----------------------------------------------
    lines.append("## Throughput")
    lines.append("")
    walls = [r.wall_time_s for r in records]
    if any(not math.isnan(w) for w in walls):
        rps = [1.0 / w if (not math.isnan(w) and w > 0) else float("nan")
               for w in walls]
        wrps = [_nanmean([rps[i] for i in range(a, b)]) for a, b in win]
        overall = _nanmean(rps)
        lines.append(f"- mean throughput: {overall:.2f} rounds/s")
        first, last = wrps[0], wrps[-1]
        if not (math.isnan(first) or math.isnan(last)) and first > 0:
            lines.append(f"- trend: {first:.2f} -> {last:.2f} rounds/s "
                         f"(first vs last window, {last / first:.2f}x)")
        lines.append(f"- rounds/s (windowed): `{_sparkline(wrps)}`")
    else:
        lines.append("_No wall-time telemetry in this run._")
    lines.append("")
    return "\n".join(lines) + "\n"
