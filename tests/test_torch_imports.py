"""``import repro_torch`` and every submodule pulls in neither JAX nor any
module of the reference package ``repro`` (checked in a fresh process)."""
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for name in repro_torch.__all__:
    getattr(repro_torch, name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
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
    assert int(n_modules) >= 15
    assert bad == "", f"port pulled in: {bad}"
