"""``import repro_torch`` and every submodule pulls in neither JAX nor any
module of the reference package ``repro`` nor ``msgpack`` (the
reference's checkpoint format; the card's machine has none), checked in a
fresh process, and ``chip_smoke.py`` imports neither (checked on its
source)."""
import ast
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
assert "repro_torch.launch.mesh" in names
assert "repro_torch.models.moe" in names
assert "repro_torch.configs.jamba_1_5_large_398b" in names
assert "repro_torch.models.encdec" in names
assert "repro_torch.configs.internvl2_2b" in names
assert "repro_torch.configs.whisper_tiny" in names
for name in ("repro_torch.sharding", "repro_torch.sharding.rules",
             "repro_torch.roofline", "repro_torch.roofline.analysis",
             "repro_torch.roofline.costs", "repro_torch.roofline.debug",
             "repro_torch.roofline.report", "repro_torch.launch.dryrun",
             "repro_torch.experiments", "repro_torch.experiments.common",
             "repro_torch.experiments.fig1_motivation",
             "repro_torch.experiments.fig5_u_sweep",
             "repro_torch.experiments.fig6_table2_main",
             "repro_torch.experiments.fig7_fassa_params",
             "repro_torch.experiments.fig8_table3_al",
             "repro_torch.experiments.run",
             "repro_torch.experiments.budget"):
    assert name in names, name
for name in names:
    importlib.import_module(name)
for name in repro_torch.__all__:
    getattr(repro_torch, name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro.") or m == "msgpack")
print(len(names))
print(",".join(bad))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().split("\n") + [""] * (
        2 - len(out.stdout.strip().split("\n")))
    assert int(n_modules) >= 85   # ... dry-run, the nine experiments
    assert bad == "", f"port pulled in: {bad}"


def test_chip_smoke_imports_neither_jax_nor_reference():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


def test_kernel_ab_script_imports_neither_jax_nor_reference():
    """``scripts/kernel_ab.py`` runs on the card's machine beside
    ``chip_smoke.py``, which has no JAX."""
    with open(os.path.join(ROOT, "scripts", "kernel_ab.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert {"chip_smoke", "repro_torch", "torch"} <= roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)



DRYRUN = r"""
import runpy, sys
sys.argv = ["dryrun", "--arch", "llama3.2-3b", "--shape", "train_4k",
            "--out-dir", sys.argv[1]]
runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
"""


def test_dryrun_cli_runs_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape
    train_4k`` writes its JSON with no JAX module loaded."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", DRYRUN, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"status": "ok"' in out.stdout
    assert os.path.exists(tmp_path / "llama3.2-3b__train_4k__16x16.json")


TWINS = ("scripts/smoke_models_torch.py", "scripts/smoke_fl_torch.py",
         "examples/serve_batch_torch.py",
         "examples/fl_silo_transformer_torch.py",
         "examples/quickstart_torch.py", "examples/paper_scale_fl_torch.py")


def test_twin_scripts_import_only_the_port():
    """The reference scripts' twins run on the card's machine, which has
    no JAX: they import ``repro_torch`` and never ``jax`` or ``repro``."""
    for path in TWINS:
        with open(os.path.join(ROOT, path)) as f:
            tree = ast.parse(f.read())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots.add((node.module or "").split(".")[0])
        assert "repro_torch" in roots, path
        assert not roots & {"jax", "jaxlib", "repro"}, (path, sorted(roots))
