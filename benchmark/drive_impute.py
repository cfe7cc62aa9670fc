"""The general driver of imputation traffic (``"kind": "impute"``): a
closed loop of one client sending requests of ``batch`` slice blocks,
each block a (subject, slice) row of the fold drawn from the seed, with
``missing`` contrasts per request drawn from the seed, zero-filled and
masked off.

Per request, timed from the call until its outputs are ready (a
synchronize): the program's on-device gather from the fold cache
(``data.device_store.gather_blocks``), the background map of the
reference modality as ``serve.serve_requests`` takes it, and the serve
step of the source that ``serve.resolve_request`` picks
(``serve.make_serve_step``, ``MultimodalModel.synthesize`` with the
fused y decode). The weights' BatchNorm statistics are calibrated on the
fold by a reference pass (``inputs.calibrated``), whose seconds are left
out of ``setup_s``. Set-up builds and warms the step of every source the
drawn requests use. ``CHECK_REQUESTS`` requests, drawn from the seed
among the first ``CHECK_SPAN``, keep their outputs for the comparison.

The traffic file gives batch (slice blocks per request) and missing
(contrasts missing per request).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, counts
from benchmark.drive_train import program_config
from benchmark.inputs import (calibrated, make_cache, make_weights,
                              meta_reference, reference_on, seeds,
                              slice_rows)
from benchmark.reference.model import F32
from benchmark.reference import train as rtrain

SLOTS = 1024            # distinct requests drawn; the window cycles them
CHECK_SPAN = 200        # the checked requests are drawn among these first
CHECK_REQUESTS = 8      # requests compared with the reference
TRACED_REQUESTS = 6     # requests a --trace 1 run profiles after the window


def draw_requests(rc: dict, traffic: dict, seed: int, presence: np.ndarray):
    """rows, slices [N, B], drop [N, B, M], source [N], ref_modality [N]
    of the first ``SLOTS`` requests (cycled beyond)."""
    from representation_disentanglement_torch.serve import resolve_request
    rng = np.random.default_rng(seed)
    subj, sl = slice_rows(rc)
    b = rc["block_size"]
    D = rc["data"]["depth"]
    sl = np.clip(sl, b, min(min(155, D) - b, D - b - 1))
    N, B = SLOTS, traffic["batch"]
    contrasts = list(rc["contrast_list"])
    M = len(contrasts)
    pick = rng.integers(0, len(subj), (N, B))
    rows, slices = subj[pick], sl[pick]
    missing = np.stack([rng.choice(M, traffic["missing"], replace=False)
                        for _ in range(N)])
    drop = np.ones((N, B, M), np.float32)
    source = np.zeros(N, np.int64)
    ref_mod = np.zeros(N, np.int64)
    for k in range(N):
        drop[k][:, missing[k]] = 0.0
        _, source[k] = resolve_request(
            contrasts, [contrasts[m] for m in missing[k]], None)
        ref_mod[k] = 0 if 0 not in missing[k] else source[k]
    return rows, slices, drop * presence[rows], source, ref_mod


def run(rc: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, started: float) -> dict:
    from representation_disentanglement_torch.data.device_store import (
        gather_blocks)
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.serve import make_serve_step

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    s_data, s_w, s_req, s_check = seeds(seed, 4)
    pcfg = program_config(rc)
    vols, tgts, presence = make_cache(rc, s_data, device)
    weights = make_weights(meta_reference(rc), s_w, device)
    sync()
    t_cal = time.perf_counter()
    weights = calibrated(rc, weights, s_w, vols, tgts, presence)
    sync()
    calibration_s = time.perf_counter() - t_cal
    rows, slices, drop, source, ref_mod = draw_requests(
        rc, traffic, s_req, presence.cpu().numpy())
    N = SLOTS
    checked = set(np.random.default_rng(s_check).choice(
        CHECK_SPAN, CHECK_REQUESTS, replace=False).tolist())

    # ---- the program's set-up ----
    model = build_model(pcfg, device=device)
    model.load_state_dict(weights)
    model.eval()
    d_rows = torch.from_numpy(rows).to(device)
    d_slices = torch.from_numpy(slices).to(device)
    d_drop = torch.from_numpy(drop).to(device)
    steps = {int(s): make_serve_step(model, pcfg, int(s), with_y=True)
             for s in np.unique(source)}
    kept = {}

    def request(k: int):
        j = k % N
        batch = gather_blocks(vols, tgts, presence, d_rows[j], d_slices[j],
                              d_drop[j], block_size=pcfg.block_size)
        mask_img = (batch["inputs"][int(ref_mod[j]), :, :, :, 0] == 0
                    ).float()
        out = steps[int(source[j])](batch["inputs"], batch["mask"],
                                    mask_img)
        sync()
        return out

    for s in steps:                         # warm every source's step
        request(int(np.flatnonzero(source == s)[0]))
    sync()
    setup_s = time.perf_counter() - started - calibration_s

    # ---- the window: one closed-loop client ----
    lat = []
    t0 = time.perf_counter()
    k = 0
    while True:
        t = time.perf_counter()
        out = request(k)
        lat.append(time.perf_counter() - t)
        if k in checked:
            kept[k] = out
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    B = traffic["batch"]
    out = {"setup_s": setup_s, "calibration_s": calibration_s,
           "window_s": window_s, "window_steps": k,
           "impute_slices_per_s": k * B / window_s,
           "impute_p95_ms": float(np.percentile(np.array(lat) * 1e3, 95))}
    if trace:
        from benchmark.trace import record

        def traced(n, first):
            for j in range(n):
                request(first + j)
            return n
        n = TRACED_REQUESTS
        out["trace"] = record(lambda: traced(n, k), sync)
        out["trace_shapes"] = record(lambda: traced(1, k + n), sync,
                                     shapes=True)
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    del model, steps
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference, after the window ----
    ref = reference_model(rc, weights, device)
    del weights
    xg, yg = [], []
    for j, (x_p, y_p) in sorted(kept.items()):
        x_r, y_r = reference_request(ref, rc, vols, tgts, presence, rows[j],
                                     slices[j], drop[j], int(source[j]),
                                     int(ref_mod[j]))
        xg.append(compare.answers(x_p, x_r))
        yg.append(compare.answers(y_p, y_r))
    out.update(attempted=k, failed=0, memory_peak=mem,
               readings=compare.imputation(xg, yg) if xg else {})
    if trace:
        out["flop_per_unit"] = counts.request_flop(rc, B)
        out["unit_s"] = window_s / k
    return out


def reference_model(rc, weights, device, quant=F32):
    return reference_on(rc, weights, device, quant=quant).eval()


def reference_request(ref, rc, vols, tgts, presence, rows, slices, drop,
                      source, ref_mod):
    """One request worked out by the reference in float32 with TF32 off,
    from the cache by its own indexing."""
    with rtrain.no_tf32():
        batch = rtrain.gather(vols, tgts, presence, rows, slices, drop,
                              rc["block_size"], ref_modality=ref_mod)
        return rtrain.synthesize(ref, batch, source)
