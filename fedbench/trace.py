"""A device trace of one measured window and its reduction to the
numbers the per-layer readers take: the device's busy time, each
kernel's time by name, and the idle gaps by what the host was doing.

The window is traced by ``torch.profiler`` (CUPTI on the card).  Device
activity is every kernel, copy and set that ran on the card; busy time is
the union of their intervals inside the window, so work that overlaps
counts once.  An idle gap is named by the innermost host operation that
covers its middle ("host: python" where none does).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "fedbench.window"


class Trace:
    """The reduced trace of one window (seconds throughout)."""

    def __init__(self, device_events: List[Tuple[str, float, float, int]],
                 host_events: List[Tuple[str, float, float, int]],
                 window: Tuple[float, float]):
        self.window = window
        lo, hi = window
        self.device = [(n, max(s, lo), min(e, hi), c)
                       for n, s, e, c in device_events if e > lo and s < hi]
        self.host = host_events
        self.window_s = hi - lo
        self.busy_s = sum(e - s for s, e in self._union())

    def _union(self):
        spans = sorted((s, e) for _, s, e, _ in self.device)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def kernel_seconds(self, *parts: str) -> float:
        """Seconds of the device events whose name holds any of ``parts``."""
        return sum(e - s for n, s, e, _ in self.device
                   if any(p in n for p in parts))

    def kernel_count(self, *parts: str) -> int:
        """Launches of the device events whose name holds any of
        ``parts``."""
        return sum(1 for n, _, _, _ in self.device
                   if any(p in n for p in parts))

    def range_seconds(self, name: str) -> float:
        """Device seconds of the work launched inside the host ranges
        called ``name``: each launch is tied to its device record by the
        trace's correlation id."""
        spans = [(s, e) for n, s, e, _ in self.host if n == name]
        corr = {c for n, s, e, c in self.host
                if c >= 0 and n != name
                and any(a <= s <= b for a, b in spans)}
        return sum(e - s for _, s, e, c in self.device if c in corr)

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time, summed by name."""
        by: Dict[str, float] = {}
        for n, s, e, _ in self.device:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time summed by the host operation that covers each
        gap's middle."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self._union():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        hosts = sorted((h for h in self.host if h[0] != WINDOW),
                       key=lambda h: h[1])
        by: Dict[str, float] = {}
        active, j = [], 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (s + e)
            while j < len(hosts) and hosts[j][1] <= mid:
                active.append(hosts[j])
                j += 1
            active = [h for h in active if h[2] >= mid]
            inner = max(active, key=lambda h: h[1]) if active else None
            key = "host: " + (short_name(inner[0]) if inner else "python")
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]


def short_name(name: str, width: int = 80) -> str:
    """A device or host operation's name without its return type,
    anonymous namespaces and argument list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.sub(r"\(.*$", "", name).strip()[:width]


def _warm(torch, device):
    """A few launches before the window, so that the profiler's first
    device records, which it can drop, are not the window's."""
    x = torch.zeros(1024, device=device)
    for _ in range(32):
        x.add_(1.0)
    torch.cuda.synchronize(device)


def traced(torch, fn: Callable, device) -> Tuple[object, Trace]:
    """(fn's result, the Trace of its window).  ``fn`` must end in a
    device synchronisation."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _warm(torch, device)
        with record_function(WINDOW):
            out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "window.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    return out, reduce_events(events)


def reduce_events(events: List[Dict]) -> Trace:
    """A Trace from chrome-trace complete events (µs)."""
    dev, host, window = [], [], None
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"]) * 1e-6
        t = s + float(e.get("dur", 0.0)) * 1e-6
        corr = int((e.get("args") or {}).get("correlation", -1))
        if cat in DEVICE_CATS:
            dev.append((name, s, t, corr))
        elif cat in HOST_CATS:
            if name == WINDOW and cat == "user_annotation":
                window = (s, t)
            host.append((name, s, t, corr))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    return Trace(dev, host, window)
