"""BENCHMARK.json parses and keeps the benchmark contract's limits, and
every cell's configuration, traffic, limits and per-layer readers are
found by name."""

import json
import re
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_a_full_check_fits_its_time():
    n = 24
    need = (2 + 14 * n) * (MAN["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert need <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in MAN[group]:
            assert NAME.match(x["name"]), x["name"]
            assert x["name"] not in seen
            seen.add(x["name"])
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def test_every_cell_finds_its_files_and_reports_enough():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        assert (ROOT / f"benchmark/configs/{w['config']}.json").is_file()
        traffic = json.loads((ROOT / f"benchmark/traffic/{w['traffic']}"
                                     ".json").read_text())
        assert (ROOT / f"benchmark/drive_{traffic['kind']}.py").is_file()
        assert (ROOT / f"benchmark/limits/{w['name']}.json").is_file()
        reported = {m["name"] for m in run.metrics_of(w, MAN, False)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = run.metrics_of(w, MAN, True)
        assert layer
        for m in layer:
            assert callable(run.reader(m["name"]))
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_traffic_files_hold_traffic_only():
    """A traffic file sets its batching and nothing of the harness's own
    (how deep the check goes, what is warmed or traced)."""
    kinds = {"train": {"kind", "batch_size", "effective_batch"},
             "impute": {"kind", "batch", "missing"}}
    for path in sorted((ROOT / "benchmark/traffic").glob("*.json")):
        traffic = json.loads(path.read_text())
        assert set(traffic) == kinds[traffic["kind"]], path.name


def test_configs_keep_the_shipped_yaml():
    """Each configuration file holds its shipped YAML's values, its
    ``reduced`` keys excepted."""
    import yaml
    for c in MAN["configs"]:
        got = json.loads((ROOT / c["file"]).read_text())
        yml = ROOT / "configs" / (c["name"] + ".yaml")
        shipped = yaml.safe_load(yml.read_text())
        for k, v in shipped.items():
            if k not in c["reduced"]:
                assert got[k] == v, k
