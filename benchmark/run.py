"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell names its configuration
(``configs/<config>.json``) and its traffic (``traffic/<traffic>.json``,
whose ``kind`` picks the driver ``drive_<kind>.py``); ``--trace 1``
reports the cell's per-layer metrics, each read by
``metrics/<metric>.py``, and ``limits/<workload>.json`` holds the limits
of the numbers that decide ``correct``.  The last line of standard output
is one JSON object; the compared numbers and their limits are also the
last lines of standard error.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# top-level module names no run may hold: JAX, its libraries, the JAX
# package, the root bench.py and the JAX package's entry module
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "representation_disentanglement_tpu", "bench", "__graft_entry__")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def few_threads() -> None:
    """One host thread for the CPU operators of a run: the window's host
    work is launches from one Python thread, and thread pools that share
    the host's cores with others only add noise.  Set before torch and
    numpy are loaded."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def fix_cache_dirs() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    base = CHECKOUT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["USE_FLAX"] = "0"


def manifest() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def cell_of(name: str, man: dict) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(cell: dict, man: dict, trace: bool):
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones."""
    e2e = [m for m in man["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in names]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, adjust=None, started: float = None) -> dict:
    """Drive one cell on ``device`` and return its result object.
    ``adjust(rc, traffic)`` may change both in place (tests shrink them
    to run on the CPU)."""
    import torch

    from benchmark import compare, counts
    from benchmark.inputs import load_config, load_traffic, run_config
    man = manifest()
    cell = cell_of(workload, man)
    traffic = load_traffic(cell["traffic"])
    rc = run_config(load_config(cell["config"]), traffic)
    if adjust is not None:
        adjust(rc, traffic)
    driver = importlib.import_module(f"benchmark.drive_{traffic['kind']}")
    res = driver.run(rc, traffic, seed, seconds, trace, torch.device(device),
                     STARTED if started is None else started)
    lim = compare.limits(workload)
    correct, checks = compare.judge(res["readings"], lim, res["failed"])
    wanted = metrics_of(cell, man, trace)
    metrics = {}
    dev_name = (torch.cuda.get_device_name(torch.device(device))
                if torch.device(device).type == "cuda" else "cpu")
    ctx = {"result": res, "trace": res.get("trace"),
           "trace_shapes": res.get("trace_shapes"), "config": rc,
           "peak": counts.peaks(dev_name)}
    for m in wanted:
        if trace:
            v = reader(m["name"])(ctx)
        else:
            v = res.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if dev_name != "cpu" else "cpu",
                      "kind": dev_name,
                      "count": cell["chips"],
                      "memory_peak_bytes": int(res["memory_peak"])}}
    tr = res.get("trace")
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
        out["window"] = {"trace_events": tr.extra["events"],
                         "trace_parse_s": tr.extra["parse_s"]}
    out["readings"] = dict(res["readings"])
    out.setdefault("window", {}).update(seconds=res["window_s"],
                                        units=res["window_steps"],
                                        setup_s=res["setup_s"])
    if "calibration_s" in res:
        out["window"]["calibration_s"] = res["calibration_s"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    few_threads()
    fix_cache_dirs()
    chips = cell_of(args.workload, manifest())["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for k, v in out["readings"].items():
        print(f"reading {k} {v}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
