"""Serving latency of the missing-modality step on the card (the JAX
package's ``tools/serve_latency.py``).

Per batch size in {1, 8, 16, 64}: the flagship serve step (``serve.
make_serve_step``, random weights from a seed) on random normal inputs
with contrast 0 missing, ``--requests`` requests each synchronized
with ``torch.cuda.synchronize()``: p50 / p95 / p99 / mean ms per request
(JAX's percentile rule, ``pct``) and slices/s at the median.  The cold
start of the live step is the first request after the model is built (the
kernel library's load, cuDNN's first plans); the AOT cold start is loading
an artifact of ``utils/aot.py`` from its file and its first request.

    python -m representation_disentanglement_torch.serve_latency
        [--requests 50] [--batches 1 8 16 64] [--aot-batch 16]
        [--aot-path PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def pct(lat, p: float) -> float:
    """JAX's rule: the entry at round(p/100 * (n - 1)) of the sorted
    latencies."""
    lat = np.sort(np.asarray(lat))
    return float(lat[min(len(lat) - 1,
                         int(round(p / 100 * (len(lat) - 1))))])


def build(batch: int, device="cuda", seed: int = 0):
    """(cfg, model, live step, inputs) for the flagship at ``batch``,
    contrast 0 missing, source 1."""
    from representation_disentanglement_torch import config, serve
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    cfg = config.flagship()
    cfg.batch_size = cfg.effective_batch = batch
    cfg = cfg.derive().validate()
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    m, h, w = cfg.modality_num, cfg.input_height, cfg.input_width
    x = rng.standard_normal((m, batch, h, w, cfg.block_ch)).astype(
        np.float32)
    x[0] = 0.0
    mask = np.ones((batch, m), np.float32)
    mask[:, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    inputs = {"inputs": x, "mask": mask, "mask_img": mask_img}
    return cfg, model, serve.make_serve_step(model, cfg, source=1), inputs


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _latencies(step, inputs, n: int, device):
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(inputs["inputs"], inputs["mask"], inputs["mask_img"])
        _sync(device)
        lat.append(time.perf_counter() - t0)
    return lat


def _summary(lat, batch: int) -> dict:
    return {"p50_ms": pct(lat, 50) * 1e3, "p95_ms": pct(lat, 95) * 1e3,
            "p99_ms": pct(lat, 99) * 1e3,
            "mean_ms": float(np.mean(lat)) * 1e3,
            "slices_per_s": batch / float(np.median(lat))}


def profile_batch(batch: int, n_requests: int, device="cuda") -> dict:
    t0 = time.perf_counter()
    _, _, step, inputs = build(batch, device)
    _sync(device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step(inputs["inputs"], inputs["mask"], inputs["mask_img"])
    _sync(device)
    cold = time.perf_counter() - t0
    lat = _latencies(step, inputs, n_requests, device)
    return dict({"batch": batch, "build_s": build_s, "cold_start_s": cold,
                 "requests": n_requests}, **_summary(lat, batch))


def profile_aot(batch: int, n_requests: int, path: str,
                device="cuda") -> dict:
    """Export the step at ``batch`` to ``path``, then load it from the file
    and time its first request (the AOT cold start) and ``n_requests``
    more; the artifact's outputs against the live step's."""
    from representation_disentanglement_torch.utils import aot
    cfg, model, live, inputs = build(batch, device)
    t0 = time.perf_counter()
    blob = aot.export_serve_step(model, cfg, source=1, sample=inputs)
    export_s = time.perf_counter() - t0
    with open(path, "wb") as f:
        f.write(blob)
    del blob
    _sync(device)
    t0 = time.perf_counter()
    step, _ = aot.load_serve_step(path)
    got = step(inputs["inputs"], inputs["mask"], inputs["mask_img"])
    _sync(device)
    cold = time.perf_counter() - t0
    want = live(inputs["inputs"], inputs["mask"], inputs["mask_img"])
    diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
    lat = _latencies(step, inputs, n_requests, device)
    return dict({"batch": batch, "aot_export_s": export_s,
                 "aot_bytes": os.path.getsize(path),
                 "aot_cold_start_s": cold, "aot_vs_live_max_abs": diff,
                 "requests": n_requests},
                **{"aot_" + k: v for k, v in _summary(lat, batch).items()})


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 16, 64])
    ap.add_argument("--aot-batch", type=int, default=16)
    ap.add_argument("--aot-path", default=None,
                    help="where the artifact is written (default: a "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = []
    for b in args.batches:
        rows.append(profile_batch(b, args.requests, args.device))
        print(json.dumps(rows[-1]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.aot_path or os.path.join(tmp, "serve.rdt")
        rows.append(profile_aot(args.aot_batch, args.requests, path,
                                args.device))
    print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
