#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (representation_disentanglement_torch).

Drives the port's serving path at the flagship configuration
(configs/brats_4mod.yaml: 4 contrasts, 160x192, 7-slice blocks, batch 16,
bf16, fused SPADE interior) on one CUDA card, with random weights from
``--seed`` and synthetic brain phantoms made with numpy:

1. print the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build every CUDA kernel of the path from ``csrc/`` with ``nvcc``;
3. hold each kernel against its plain PyTorch version at the shapes the
   serving path gives it;
4. answer three missing-modality requests through ``serve.serve_requests``
   and check the outputs and that every SPADE block went through the kernel;
5. answer one request again with the SPADE interior forced to the plain
   version, and a small f32 model both ways, and compare;
6. time the serve step and each kernel launch beside its bound.

Every phase that fails ends the run with a non-zero exit.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.

Run from the root of the repository:  python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Memory rate (bytes/s) by card name; published data-sheet figures.
_MEM_RATE = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12)]
_F32_PEAK = 67e12          # H100 SXM f32 outside the tensor cores, FLOP/s
_F32_PEAK_BY_NAME = [("H100 PCIe", 51e12), ("H100 NVL", 60e12)]
# the six SPADE blocks of the serving path: (name, C, H, W); N = M * B
SPADE_SHAPES = [("sp1", 128, 5, 6), ("sp2", 128, 10, 12),
                ("sp3", 128, 20, 24), ("sp4", 128, 40, 48),
                ("sp5", 64, 80, 96), ("sp6", 32, 160, 192)]
IN_MODULATE_FLOPS_PER_ELEM = 10   # sum, centred square-sum, normalize, modulate
BF16_ULPS = 2.0
F32_ATOL = 1e-5
SERVE_REL_L2 = 5e-2
F32_MODEL_REL_L2 = 1e-4
SERVE_SLICES = 40                 # per request: 3 serve steps at B=16
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _lookup(table, name, default):
    for key, val in table:
        if key in name:
            return val
    return default


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def bf16_tolerance(torch, ref):
    """BF16_ULPS units in the last place of bf16 at each |ref|, plus the f32
    tolerance F32_ATOL: kernel and plain evaluate the same f32 arithmetic in
    another order before the kernel's one rounding."""
    _, exp = torch.frexp(ref.abs().clamp_min(2.0 ** -100))
    return BF16_ULPS * torch.pow(2.0, (exp - 8).float()) + F32_ATOL


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(torch, seed: int):
    """(label, zi, gamma, beta) at every SPADE shape of the serving path
    (bf16, N = 64), one f32 shape, and both mixed-dtype pairings."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n = 64

    def mk(c, h, w, zd, gd):
        shape = (n, c, h, w)
        zi = (3.0 + 2.0 * torch.randn(shape, generator=g, device=DEVICE)
              ).to(zd)
        gamma = (0.5 * torch.randn(shape, generator=g, device=DEVICE)).to(gd)
        beta = (0.5 * torch.randn(shape, generator=g, device=DEVICE)).to(gd)
        return zi, gamma, beta

    bf, f32 = torch.bfloat16, torch.float32
    for name, c, h, w in SPADE_SHAPES:
        yield (name, "bf16") + mk(c, h, w, bf, bf)
    yield ("sp4", "f32") + mk(128, 40, 48, f32, f32)
    yield ("sp5", "bf16-zi/f32-gamma") + mk(64, 80, 96, bf, f32)
    yield ("sp1", "f32-zi/bf16-gamma") + mk(128, 5, 6, f32, bf)


def check_kernels(torch, kernels, seed: int):
    """Kernel against plain (computed in f32 from the same inputs)."""
    worst = 0.0
    for name, dtypes, zi, gamma, beta in kernel_cases(torch, seed):
        got = kernels.in_modulate_cuda(zi, gamma, beta)
        torch.cuda.synchronize()
        ref = kernels.in_modulate_plain(zi.float(), gamma.float(),
                                        beta.float())
        err = (got.float() - ref).abs()
        check(bool(torch.isfinite(got).all()), f"{name} {dtypes}: non-finite")
        if zi.dtype == torch.bfloat16:
            tol = bf16_tolerance(torch, ref)
            ok = bool((err <= tol).all())
            tol_txt = f"{BF16_ULPS} bf16 ulps of the output + {F32_ATOL}"
        else:
            ok = float(err.max()) <= F32_ATOL
            tol_txt = f"atol {F32_ATOL}"
        max_err = float(err.max())
        worst = max(worst, max_err)
        rec = {"phase": "kernel_check", "kernel": "in_modulate",
               "block": name, "dtypes": dtypes, "shape": list(zi.shape),
               "max_abs_err": max_err, "tolerance": tol_txt, "ok": ok}
        if not ok:
            bad = int((err - tol).argmax())
            rec["worst"] = {"index": bad,
                            "got": float(got.flatten()[bad].float()),
                            "ref": float(ref.flatten()[bad]),
                            "zi": float(zi.flatten()[bad].float()),
                            "gamma": float(gamma.flatten()[bad].float()),
                            "beta": float(beta.flatten()[bad].float())}
        emit(rec)
        check(ok, f"in_modulate disagrees with plain at {name} {dtypes}")
    return worst


def phantoms(rng, m: int, n: int, h: int, w: int, cb: int) -> np.ndarray:
    """[M, N, H, W, Cb] z-scored brain phantoms: an elliptical head with
    grey/white matter, ventricles and a lesion whose contrast differs per
    modality; background exactly 0."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    # tissue intensities per contrast: (white, grey, csf, lesion)
    tissue = np.array([[0.9, 0.6, 0.1, 0.5], [0.9, 0.6, 0.1, 1.0],
                       [0.5, 0.7, 1.0, 0.9], [0.6, 0.7, 0.1, 1.0]])
    out = np.zeros((m, n, h, w, cb), np.float32)
    for i in range(n):
        for k in range(cb):
            z = (i + k - cb // 2) / max(n, 1)
            sy, sx = 0.85 - 0.2 * z * z, 0.75 - 0.2 * z * z
            r = (yy / sy) ** 2 + (xx / sx) ** 2
            head = r < 1.0
            white = r < 0.45
            csf = ((yy / 0.25) ** 2 + (xx / 0.12) ** 2) < 1.0
            cy, cx = rng.uniform(-0.4, 0.4, 2)
            lesion = ((yy - cy) ** 2 + (xx - cx) ** 2) < 0.02
            for c in range(m):
                img = np.where(head, tissue[c % 4, 1], 0.0)
                img = np.where(white, tissue[c % 4, 0], img)
                img = np.where(csf & head, tissue[c % 4, 2], img)
                img = np.where(lesion & head, tissue[c % 4, 3], img)
                img = img + head * rng.normal(0, 0.03, (h, w))
                v = img[head]
                img = np.where(head, (img - v.mean()) / (v.std() + 1e-6), 0.0)
                out[c, i, :, :, k] = img
    return out


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from representation_disentanglement_torch import config, serve
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.ops import kernels

    # 1. the card
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mem_rate = _lookup(_MEM_RATE, kind, 3.35e12)
    f32_peak = _lookup(_F32_PEAK_BY_NAME, kind, _F32_PEAK)
    emit({"phase": "card", "nvidia_smi": card, "device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "mem_rate_bytes_per_s": mem_rate})

    # 2. build
    t0 = time.perf_counter()
    logs = kernels.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[nvcc {name}] {line.strip()}", flush=True)
    emit({"phase": "build", "kernels": sorted(logs),
          "flags": " ".join(kernels.NVCC_FLAGS),
          "seconds": time.perf_counter() - t0})

    # 3. kernel against plain
    max_err = check_kernels(torch, kernels, args.seed)

    # 4. the serving path at flagship width
    cfg = config.flagship()
    gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, generator=gen)
    emit({"phase": "model", "params": sum(p.numel()
                                          for p in model.parameters()),
          "contrasts": cfg.contrast_list, "input_size": cfg.input_size,
          "batch": cfg.batch_size, "compute_dtype": cfg.compute_dtype,
          "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(args.seed)
    M, H, W = cfg.modality_num, cfg.input_height, cfg.input_width
    inputs = phantoms(rng, M, SERVE_SLICES, H, W, cfg.block_ch)
    requests = [dict(missing=["T1"]),
                dict(missing=["T2", "T2_FLAIR"], source="T1c"),
                dict(missing=["T1", "T1c"])]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = [serve.serve_requests(model, cfg, inputs, **r)
               for r in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    steps = sum(r["steps"] for r in results)
    for req, res in zip(requests, results):
        for c, vol in res["x_hat"].items():
            check(vol.shape == (SERVE_SLICES, H, W),
                  f"x_hat[{c}] has shape {vol.shape}")
            check(bool(np.isfinite(vol).all()), f"x_hat[{c}] not finite")
            check(float(vol.std()) > 0, f"x_hat[{c}] is constant")
        check(res["y"].shape == (SERVE_SLICES, H, W), "y has wrong shape")
        check(bool(np.isfinite(res["y"]).all()), "y not finite")
        check(set(res["x_hat"]) == set(req["missing"]) | {res["source"]},
              "returned contrasts differ from the request")
    emit({"phase": "serve", "requests": requests, "slices_per_request":
          SERVE_SLICES, "steps": steps, "launches": launches,
          "wall_s": wall})
    check(launches["in_modulate"] == 6 * steps,
          f"in_modulate launched {launches['in_modulate']} times in "
          f"{steps} serve steps; expected 6 per step")

    # 5. the same request with the plain SPADE interior
    model.set_use_pallas(False)
    plain = serve.serve_requests(model, cfg, inputs, **requests[0])
    model.set_use_pallas(True)
    gaps = {c: rel_l2(results[0]["x_hat"][c], plain["x_hat"][c])
            for c in plain["x_hat"]}
    gaps["y"] = rel_l2(results[0]["y"], plain["y"])
    emit({"phase": "kernel_vs_plain_serve", "dtype": "bf16",
          "rel_l2": gaps, "tolerance": SERVE_REL_L2})
    check(max(gaps.values()) <= SERVE_REL_L2,
          "bf16 serve outputs: kernel and plain interiors disagree")
    small = config.flagship()
    small.input_height, small.input_width = 64, 96
    small.compute_dtype, small.batch_size = "float32", 2
    m32 = build_model(small, device=DEVICE,
                      generator=torch.Generator().manual_seed(args.seed))
    x32 = phantoms(rng, M, 2, 64, 96, small.block_ch)
    mask = np.ones((2, M), np.float32)
    mask[:, 0] = 0.0
    x32[0] = 0.0
    step32 = serve.make_serve_step(m32, small, source=1)
    mask_img = (x32[1, :, :, :, 0] == 0).astype(np.float32)
    xk, yk = (t.cpu().numpy() for t in step32(x32, mask, mask_img))
    m32.set_use_pallas(False)
    xp, yp = (t.cpu().numpy() for t in step32(x32, mask, mask_img))
    gap32 = {"x_hat": rel_l2(xk, xp), "y": rel_l2(yk, yp)}
    emit({"phase": "kernel_vs_plain_f32_model", "input_size": [64, 96],
          "rel_l2": gap32, "tolerance": F32_MODEL_REL_L2})
    check(max(gap32.values()) <= F32_MODEL_REL_L2,
          "f32 model: kernel and plain interiors disagree")
    del m32

    # 6. timings
    B = cfg.batch_size
    step = serve.make_serve_step(model, cfg, source=1)
    xb = torch.as_tensor(inputs[:, :B], device=DEVICE)
    mb = torch.ones(B, M, device=DEVICE)
    mb[:, 0] = 0.0
    xb[0] = 0.0
    mib = (xb[1, :, :, :, 0] == 0).float()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, lambda: step(xb, mb, mib), iters=20)
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(xb, mb, mib)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "serve_timing", "card": card, "batch": B,
          "step_ms": step_ms, "slices_per_s": B / step_ms * 1e3,
          "sync_latency_ms_p50": float(np.median(lat)),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by_ops = False
    for name, dtypes, zi, gamma, beta in kernel_cases(torch, args.seed):
        if dtypes != "bf16":
            continue
        k_ms = time_ms(torch, lambda: kernels.in_modulate_cuda(
            zi, gamma, beta), iters=50)
        p_ms = time_ms(torch, lambda: kernels.in_modulate_plain(
            zi, gamma, beta), iters=20)
        nbytes = 4 * zi.numel() * zi.element_size()
        bytes_ms = nbytes / mem_rate * 1e3
        ops_ms = IN_MODULATE_FLOPS_PER_ELEM * zi.numel() / f32_peak * 1e3
        bound = max(bytes_ms, ops_ms)
        bound_by_ops |= ops_ms > bytes_ms
        totals["ms"] += k_ms
        totals["plain_ms"] += p_ms
        totals["bound_ms"] += bound
        emit({"phase": "kernel_timing", "kernel": "in_modulate",
              "block": name, "shape": list(zi.shape), "card": card,
              "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
              "bytes": nbytes, "bound_share": bound / k_ms})
    del zi, gamma, beta

    print(card, flush=True)
    emit({"kernels": [{
        "name": "in_modulate", "route": "cuda",
        "source": "representation_disentanglement_torch/csrc/in_modulate.cu",
        "replaces": "representation_disentanglement_tpu/ops/pallas_kernels.py:172",
        "replaces_also": "representation_disentanglement_tpu/ops/pallas_kernels.py:75",
        "launches": launches["in_modulate"], "max_abs_err": max_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "operations" if bound_by_ops else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes instance-norm "
                        "plus modulation",
        "times_are": "sum over the six SPADE launches of one serve step"}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
