"""Shared pieces of the benchmark's CPU tests: the program on the path,
and tiny copies of the cells that the CPU can run."""
from __future__ import annotations

import copy
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

import torch  # noqa: E402

from fedbench.outcome import Job  # noqa: E402
from fedbench.registry import Registry  # noqa: E402

torch.set_num_threads(1)

FL_CELL = "femnist-mclr.scan-iid"
SILO_CELL = "falcon-mamba-7b.silo"
SEED = 2 ** 31 + 12345


def registry() -> Registry:
    return Registry(ROOT)


def tiny_fl(sampling: str = "iid"):
    """The FL cell with 20 clients of 16 features, blocks of 4 rounds."""
    cell = copy.deepcopy(registry().cell(FL_CELL))
    cell.config["dataset"].update(n_clients=20, total=600, dim=16,
                                  max_size=60)
    cell.traffic.update(sampling=sampling, warm_rounds=4, trace_rounds=4,
                        draw_pool=8, block_size=4, eval_every=4)
    return cell


def tiny_silo(compute: str = "float32"):
    """The silo cell at a two-layer model of width 64, 64 positions."""
    cell = copy.deepcopy(registry().cell(SILO_CELL))
    cell.config.update(hidden_size=64, intermediate_size=128, state_size=8,
                       vocab_size=512, time_step_rank=4,
                       num_hidden_layers=2, compute_dtype=compute)
    cell.traffic.update(seq_len=64, token_pool=4)
    return cell


def job(cell, seed: int = SEED, seconds: float = 0.3,
        trace: bool = False) -> Job:
    return Job(cell=cell, seed=seed, seconds=seconds, trace=trace,
               device="cpu", t_start=time.perf_counter())


def run(cell, **kw):
    """The cell's driver run on the CPU: its Outcome."""
    return registry().driver(cell.driver).run(job(cell, **kw))
