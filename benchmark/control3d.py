"""Readings for the limits of a 3D training cell: the program's sound runs
over many seeds and the control, in one process.  Not part of a benchmark
run.

    python3 -m benchmark.control3d --workload NAME --seeds S [S ...]
        [--seconds SECONDS] [--control]

Each seed runs the cell's timed path (``run.run_cell``) with a window of
SECONDS and prints its readings.  ``--control`` runs it once more with
the crops fed to the step in bfloat16 (the configuration's
``volume_dtype``, as ``bench3d --dtype bfloat16`` feeds them: the
convolutions then run in bfloat16, the precision below the TF32 the
configuration states), compared with the same float32 reference.  One
JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    from benchmark.run import few_threads, fix_cache_dirs, run_cell
    few_threads()
    fix_cache_dirs()
    device = torch.device("cuda:0")
    variants = {"program": None}
    if args.control:
        variants["control"] = lambda rc, traffic: rc.update(
            volume_dtype="bfloat16")
    for seed in args.seeds:
        for name, adjust in variants.items():
            t = time.perf_counter()
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            res = run_cell(args.workload, seed, args.seconds, False, device,
                           adjust, started=time.perf_counter())
            print(json.dumps({"seed": seed, "variant": name,
                              "correct": res["correct"],
                              "readings": res["readings"],
                              "metrics": res["metrics"],
                              "peak": res["device"]["memory_peak_bytes"],
                              "s": time.perf_counter() - t}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
