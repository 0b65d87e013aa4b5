"""The program's own host spans in a traced window, for the readers of
the per-layer metrics that time them: the scan driver's ``fed.block``
span a block of rounds and its children, the silo path's
``fed.local_step`` span a local step and its children
(``repro_torch.obs.profiling``'s ``SPAN_*`` names).  A program without
them gives no span, and the readers then give no number."""
from __future__ import annotations

from typing import List, Tuple

from fedbench.trace import WINDOW


def spans(trace, name: str) -> List[Tuple[float, float]]:
    """(start, end) of each host range called ``name`` that lies inside
    the traced window, in order of start; none without a trace."""
    if trace is None:
        return []
    windows = [(s, e) for n, s, e, _ in trace.host if n == WINDOW]
    return sorted((s, e) for n, s, e, _ in trace.host if n == name
                  and any(lo <= s and e <= hi for lo, hi in windows))


def inside(children: List[Tuple[float, float]],
           parent: Tuple[float, float]) -> float:
    """Seconds of the ``children`` ranges that lie inside ``parent``."""
    lo, hi = parent
    return sum(e - s for s, e in children if lo <= s and e <= hi)
