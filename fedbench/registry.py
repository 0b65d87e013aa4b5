"""The benchmark's registry: everything a cell needs, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics.  Each piece lives in a file of its own, named after
it, so that a later change adds a configuration, a cell or a metric by
adding files:

    fedbench/configs/<config>.json     a configuration's sizes
    fedbench/workloads/<cell>.json     a cell's traffic and the driver that
                                       runs it, with its check's limits
    fedbench/drivers/<driver>.py       ``run(job) -> Outcome``, one per way
                                       of driving the program
    fedbench/metrics/<metric>.py       ``read(outcome) -> float | None``
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""
    name: str
    entry: Dict          # the BENCHMARK.json entry
    config: Dict         # the configuration's file
    traffic: Dict        # the cell's file
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


class Registry:
    """``BENCHMARK.json`` (at ``root``) and the files it names."""

    def __init__(self, root: str = ROOT, bench: Optional[Dict] = None):
        self.root = root
        self.bench = (bench if bench is not None
                      else _load_json(os.path.join(root, "BENCHMARK.json")))

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, "fedbench", *parts)

    def cell_names(self) -> List[str]:
        return [w["name"] for w in self.bench["workloads"]]

    def cell(self, name: str) -> Cell:
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r}; known: {sorted(entries)}")
        entry = entries[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        config = _load_json(os.path.join(self.root,
                                         configs[entry["config"]]["file"]))
        traffic = _load_json(self.path("workloads", f"{name}.json"))
        e2e = [m for m in self.bench["end_to_end"]
               if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        layer = [m for m in self.bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
        return Cell(name, entry, config, traffic, e2e, layer)

    def driver(self, name: str):
        return _load_module(self.path("drivers", f"{name}.py"),
                            f"fedbench_driver_{name}")

    def reader(self, metric: str):
        """The metric's ``read`` function."""
        mod = _load_module(self.path("metrics", f"{metric}.py"),
                           "fedbench_metric_" + metric.replace(".", "_"))
        return mod.read
