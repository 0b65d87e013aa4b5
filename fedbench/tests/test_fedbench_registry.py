"""The registry finds configurations, cells and metrics by name, a later
change adds each as new files, and BENCHMARK.json keeps to its format."""
import hashlib
import json
import os
import re
import shutil

import pytest

from fedbench.tests import helpers
from fedbench.registry import Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(helpers.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves_with_its_files(bench):
    reg = helpers.registry()
    for name in reg.cell_names():
        cell = reg.cell(name)
        assert cell.config and cell.traffic["limits"]
        assert reg.driver(cell.driver).run
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(reg.reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_unknown_names_raise():
    reg = helpers.registry()
    with pytest.raises(KeyError):
        reg.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric")


def test_benchmark_json_keeps_to_its_format(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "fedbench/run.py"]
    assert bench["paths"] == ["fedbench"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("fedbench/")
        assert os.path.isfile(os.path.join(helpers.ROOT, c["file"]))
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        used.add(w["config"])
    assert used == configs
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25
               for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) <= 64 * 1024


def _tree_hashes(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_config_a_cell_and_a_metric_are_added_as_new_files(tmp_path,
                                                              bench):
    shutil.copytree(os.path.join(helpers.ROOT, "fedbench"),
                    tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_hashes(tmp_path / "fedbench")
    cfg = json.load(open(tmp_path / "fedbench/configs/femnist-mclr.json"))
    cfg["dataset"]["n_clients"] = 1000
    (tmp_path / "fedbench/configs/mnist-mclr.json").write_text(
        json.dumps(cfg))
    cell = json.load(open(
        tmp_path / "fedbench/workloads/femnist-mclr.scan-iid.json"))
    (tmp_path / "fedbench/workloads/mnist-mclr.scan-iid.json").write_text(
        json.dumps(cell))
    (tmp_path / "fedbench/metrics/rounds_seen.fl.py").write_text(
        "def read(o):\n    return float(o.counters['rounds'])\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append(dict(bench["configs"][0], name="mnist-mclr",
                               file="fedbench/configs/mnist-mclr.json"))
    new["workloads"].append(dict(bench["workloads"][0],
                                 name="mnist-mclr.scan-iid",
                                 config="mnist-mclr"))
    for m in new["end_to_end"]:
        if "femnist-mclr.scan-iid" in m.get("workloads", []):
            m["workloads"].append("mnist-mclr.scan-iid")
    new["per_layer"].append({"name": "rounds_seen.fl", "unit": "rounds",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "rounds_per_s",
                             "workloads": ["mnist-mclr.scan-iid"]})
    reg = Registry(str(tmp_path), bench=new)
    got = reg.cell("mnist-mclr.scan-iid")
    assert got.config["dataset"]["n_clients"] == 1000
    assert got.driver == "fl_scan"
    assert "rounds_seen.fl" in [m["name"] for m in got.per_layer]

    class Seen:
        counters = {"rounds": 7}
    assert reg.reader("rounds_seen.fl")(Seen) == 7.0
    after = _tree_hashes(tmp_path / "fedbench")
    assert {k: after[k] for k in before} == before
