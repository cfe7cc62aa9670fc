"""Readings for the limits: the program's sound runs over many seeds, the
control and the planted faults, in one process.  Not part of a benchmark
run.

    python3 -m benchmark.control --workload NAME --seeds S [S ...]
        [--program SECONDS] [--control] [--faults]

``--program`` runs the cell's timed path (``run.run_cell``) for each seed
with a window of SECONDS and prints its readings.  ``--control`` puts the
reference, its products' operands rounded to float8 e4m3 (the precision
below the configuration's bfloat16), in the program's place and compares
it with the float32 reference as a run compares the program.
``--faults`` plants the cell's faults in the reference put in the
program's place: for training, half of every microbatch left out (the
mean over the rest); for imputation, each answer replaced by its
neighbour's.  A training step that returns its state unchanged reads 1
on the change by construction.  One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import compare
from benchmark.inputs import (calibrated, load_config, load_traffic,
                              make_cache, make_weights, meta_reference,
                              run_config, seeds)
from benchmark.reference.model import FP8


def _cell(workload: str):
    from benchmark.run import cell_of, manifest
    cell = cell_of(workload, manifest())
    traffic = load_traffic(cell["traffic"])
    return run_config(load_config(cell["config"]), traffic), traffic


def train_readings(rc, traffic, seed, variants, device):
    from benchmark.drive_train import CHECKED_STEPS, reference_steps
    s_data, s_w, s_loader, s_pair, s_z = seeds(seed, 5)
    vols, tgts, presence = make_cache(rc, s_data, device)
    w0 = make_weights(meta_reference(rc), s_w, device)
    n = CHECKED_STEPS
    args = (rc, w0, vols, tgts, presence, s_loader, s_pair, s_z, n, device)
    ref = reference_steps(*args)
    out = {}
    for v in variants:
        got = reference_steps(*args, quant=FP8 if v == "control" else None,
                              rows_kept=rc["batch_size"] // 2
                              if v == "half_batch" else None)
        out[v] = compare.training(got, ref)
    return out


def impute_readings(rc, traffic, seed, variants, device):
    from benchmark import drive_impute as di
    s_data, s_w, s_req, s_check = seeds(seed, 4)
    vols, tgts, presence = make_cache(rc, s_data, device)
    weights = calibrated(rc, make_weights(meta_reference(rc), s_w, device),
                         s_w, vols, tgts, presence)
    rows, slices, drop, source, ref_mod = di.draw_requests(
        rc, traffic, s_req, presence.cpu().numpy())
    checked = sorted(np.random.default_rng(s_check).choice(
        di.CHECK_SPAN, di.CHECK_REQUESTS, replace=False).tolist())
    ref = di.reference_model(rc, weights, device)
    ctl = di.reference_model(rc, weights, device, FP8)
    gaps = {v: ([], []) for v in variants}
    for j in checked:
        a = (rc, vols, tgts, presence, rows[j], slices[j], drop[j],
             int(source[j]), int(ref_mod[j]))
        x_r, y_r = di.reference_request(ref, *a)
        for v in variants:
            if v == "control":
                x_v, y_v = di.reference_request(ctl, *a)
            else:                               # answers shifted by one
                x_v, y_v = x_r.roll(1, dims=1), y_r.roll(1, dims=0)
            gaps[v][0].append(compare.answers(x_v, x_r))
            gaps[v][1].append(compare.answers(y_v, y_r))
    return {v: compare.imputation(*g) for v, g in gaps.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    from benchmark.run import fix_cache_dirs, run_cell
    fix_cache_dirs()
    device = torch.device("cuda:0")
    rc, traffic = _cell(args.workload)
    variants = (["control"] if args.control else []) + (
        [{"train": "half_batch", "impute": "shifted_answers"}[
            traffic["kind"]]] if args.faults else [])
    for seed in args.seeds:
        t = time.perf_counter()
        if args.program:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            res = run_cell(args.workload, seed, args.program, False, device,
                           started=time.perf_counter())
            print(json.dumps({"seed": seed, "variant": "program",
                              "readings": res["readings"],
                              "metrics": res["metrics"],
                              "peak": res["device"]["memory_peak_bytes"],
                              "s": time.perf_counter() - t}), flush=True)
        if variants:
            fn = train_readings if traffic["kind"] == "train" \
                else impute_readings
            for v, r in fn(rc, traffic, seed, variants, device).items():
                print(json.dumps({"seed": seed, "variant": v,
                                  "readings": r,
                                  "s": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
