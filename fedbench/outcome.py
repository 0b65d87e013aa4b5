"""What a cell's driver is given and what it hands back."""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Optional

from fedbench.registry import Cell
from fedbench.trace import Trace


@dataclasses.dataclass
class Job:
    """One run of one cell."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float           # the process's start, ``time.perf_counter()``

    def lap(self, what: str):
        """Print the seconds since the process started, on standard
        error: where the run's time goes."""
        print(f"fedbench: {what} at {time.perf_counter() - self.t_start:.3f}"
              f" s", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """A driver's result: the end-to-end metrics of an untraced run, the
    counters and the trace of a traced one, and the numbers that decide
    ``correct`` (each compared with ``limits``)."""
    cell: Cell
    end_to_end: Dict[str, float]
    counters: Dict[str, float]
    readings: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[Trace] = None
