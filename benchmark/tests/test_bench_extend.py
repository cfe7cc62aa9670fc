"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as files of their own and manifest entries, and edits no file
the benchmark has: the harness finds them by name."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_RUN = """
import json, sys
from benchmark.run import run_cell
from benchmark.tests.bench_tiny import tiny_drivers
with tiny_drivers():
    out = run_cell("dummy-cell", 7, 0.01, True, "cpu")
print(json.dumps({"metrics": out["metrics"], "correct": out["correct"]}))
"""


def test_a_cell_added_as_new_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs/brats_4mod.json").read_text())
    cfg.update(input_height=32, input_width=64, compute_dtype="float32")
    cfg["data"] = {"cohort": 12, "depth": 20, "slice_range": [5, 15]}
    (b / "configs/dummy_cfg.json").write_text(json.dumps(cfg))
    (b / "traffic/dummy_mix.json").write_text(json.dumps(
        {"kind": "impute", "batch": 2, "missing": 2}))
    (b / "limits/dummy-cell.json").write_text(json.dumps(
        {"limits": {"xhat_gap": 1e-3}}))
    (b / "metrics/dummy_units.py").write_text(
        "def read(ctx):\n    return ctx['trace'].units\n")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy_cfg", "source": "test",
                           "file": "benchmark/configs/dummy_cfg.json",
                           "reduced": ["input_height"], "why": "test"})
    man["workloads"].append({"name": "dummy-cell", "config": "dummy_cfg",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "impute_slices_per_s":
            m["workloads"].append("dummy-cell")
    man["per_layer"].append({"name": "dummy_units", "unit": "requests",
                             "better": "higher", "source": "device_trace",
                             "layer": "step", "moves": "impute_slices_per_s",
                             "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = {p: p.read_bytes() for p in before}
    assert after == before                     # no file of the harness edited
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", _RUN], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"]["dummy_units"]["value"] == 1.0
