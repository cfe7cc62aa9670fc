"""A run holds nothing of JAX, the JAX package, the root bench.py or
__graft_entry__ (top-level module names compared whole), and the plain
reference imports nothing of the measured package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
PORT = "representation_disentanglement_torch"

_PROBE = """
import importlib, pkgutil, sys
import benchmark
from benchmark.tests.bench_tiny import run_tiny
names = [m.name for m in pkgutil.walk_packages(benchmark.__path__,
                                               "benchmark.")]
for name in names:
    importlib.import_module(name)
run_tiny("flagship-impute-b64")
from benchmark.run import forbidden_modules
print(len(names), forbidden_modules())
"""


def test_names_are_compared_whole():
    mods = ["jax.numpy", "flax", "bench", "__graft_entry__",
            "representation_disentanglement_tpu.models", "benchmark.run",
            "jaxtyping", "bench_tools", PORT, PORT + ".bench",
            "representation_disentanglement_tpu_x"]
    assert run.forbidden_modules(mods) == sorted(
        ["jax.numpy", "flax", "bench", "__graft_entry__",
         "representation_disentanglement_tpu.models"])


def test_a_run_loads_nothing_forbidden():
    """Every module of benchmark/ imported and a tiny cell driven in a
    fresh process: no forbidden top-level name in sys.modules."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    count, bad = res.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) >= 10
    assert bad == "[]", bad


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in BENCH.rglob("*.py")))
def test_no_forbidden_import_in_the_sources(path):
    names = list(_imports(ROOT / path))
    assert not run.forbidden_modules(names), path
    if "reference" in Path(path).parts:
        assert not [n for n in names if n.split(".")[0] == PORT], path
