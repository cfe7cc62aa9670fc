#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (representation_disentanglement_torch).

Drives the port's two paths, serving and training, at the flagship
configuration (configs/brats_4mod.yaml: 4 contrasts, 160x192, 7-slice
blocks, batch 16, bf16, fused SPADE interior, the shipped five losses) on
one CUDA card, with random weights from ``--seed`` and synthetic brain
phantoms made with numpy:

1. print the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build every CUDA kernel of the paths from ``csrc/`` with ``nvcc``;
3. hold the forward kernel against its plain PyTorch version at the shapes
   the serving path gives it, and the backward kernel against its plain
   version at the shapes the train step gives it (``kernel_check_bwd``);
4. answer three missing-modality requests through ``serve.serve_requests``
   and check the outputs and that every SPADE block went through the kernel;
5. answer one request again with the SPADE interior forced to the plain
   version, and a small f32 model both ways, and compare;
6. time the serve step and each forward launch beside its bound;
7. take five Adam steps through ``training.train.make_train_step`` on one
   fixed batch (``train``): finite metrics, a total and a reconstruction
   loss lower at the last step than at the first,
   gradients on every parameter the losses reach, moved BatchNorm
   statistics, and 3 + 3*M launches of each kernel per step;
8. compare the losses and gradients of one step with the kernels and with
   the plain interior, at flagship bf16 and on a small f32 model
   (``train_kernel_vs_plain``);
9. time the train step, and the same step with the plain interior
   (``train_timing``), and each backward and forward launch at the
   training shapes beside its bound (``kernel_timing_bwd``).

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
SHARED_BLOCKS = ("sp1", "sp2", "sp3")   # the shared SPADE half
IN_MODULATE_FLOPS_PER_ELEM = 10   # sum, centred square-sum, normalize, modulate
# backward: mean; centred square, dzin, two products and three sums; zin,
# dzin, dz and dgamma
IN_MODULATE_BWD_FLOPS_PER_ELEM = 16
BF16_ULPS = 2.0
F32_ATOL = 1e-5
# backward tolerance: 2 bf16 ulps of the output (bf16 outputs) plus
# BWD_REL times the magnitudes that enter the output (bwd_tolerance)
BWD_REL = 2.0 ** -18
SERVE_REL_L2 = 5e-2
F32_MODEL_REL_L2 = 1e-4
SERVE_SLICES = 40                 # per request: 3 serve steps at B=16
TRAIN_STEPS = 5
TRAIN_TIMED_STEPS = 10
# one step with the kernels against the plain interior, from the same
# weights, batch and noise; measured on an H100 (700 W): bf16 losses 2.5e-5
# relative and gradients 7.7e-4 relative L2, f32 losses equal and gradients
# 5.4e-7
TRAIN_BF16_LOSS_REL = 1e-3
TRAIN_BF16_GRAD_REL_L2 = 1e-2
TRAIN_F32_LOSS_REL = 1e-5
TRAIN_F32_GRAD_REL_L2 = 1e-4
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


def bf16_ulps(torch, ref):
    """BF16_ULPS units in the last place of bf16 at each |ref|."""
    _, exp = torch.frexp(ref.abs().clamp_min(2.0 ** -100))
    return BF16_ULPS * torch.pow(2.0, (exp - 8).float())


def bf16_tolerance(torch, ref):
    """bf16_ulps plus the f32 tolerance F32_ATOL: kernel and plain evaluate
    the same f32 arithmetic in another order before the kernel's one
    rounding."""
    return bf16_ulps(torch, ref) + F32_ATOL


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


def train_shapes(m: int, b: int):
    """(name, N, C, H, W) of each SPADE block in one train step: the shared
    half runs on the M*M*B decode grid, each not-shared half on M*B."""
    return [(name, (m * m * b if name in SHARED_BLOCKS else m * b), c, h, w)
            for name, c, h, w in SPADE_SHAPES]


def bwd_cases(torch, seed: int, shapes):
    """(label, dtypes, zi, gamma, g) at every training shape in bf16, one f32
    shape and both mixed-dtype pairings; g has zi's dtype."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)

    def mk(n, c, h, w, zd, gd):
        shape = (n, c, h, w)
        rnd = lambda: torch.randn(shape, generator=gen, device=DEVICE)
        return ((3.0 + 2.0 * rnd()).to(zd), (0.5 * rnd()).to(gd),
                rnd().to(zd))

    bf, f32 = torch.bfloat16, torch.float32
    by_name = {s[0]: s[1:] for s in shapes}
    for name, n, c, h, w in shapes:
        yield (name, "bf16") + mk(n, c, h, w, bf, bf)
    yield ("sp4", "f32") + mk(*by_name["sp4"], f32, f32)
    yield ("sp5", "bf16-zi/f32-gamma") + mk(*by_name["sp5"], bf, f32)
    yield ("sp1", "f32-zi/bf16-gamma") + mk(*by_name["sp1"], f32, bf)


def bwd_tolerance(torch, zi, gamma, g, eps=1e-5):
    """Per-element tolerances of (dz, dgamma): BWD_REL times the magnitudes
    that enter each output, plus 2 bf16 ulps of a bf16 output.

    dz = rstd (dzin - m1 - zin m2) cancels, so its error follows the terms,
    not the result: rstd (|dzin| + mean|dzin| + (|zin| + |mean| rstd)
    mean|dzin zin|).  The plane means bound the summation error of m1 and
    m2, and |mean| rstd the error that the mean's rounding puts into zin.
    dgamma = g zin: |g| (|zin| + |mean| rstd)."""
    z, g32 = zi.float(), g.float()
    mean = z.mean(dim=(-2, -1), keepdim=True)
    rstd = torch.rsqrt((z - mean).square().mean(dim=(-2, -1), keepdim=True)
                       + eps)
    zin = (z - mean) * rstd
    dzin = g32 * (1.0 + gamma.float())
    a1 = dzin.abs().mean(dim=(-2, -1), keepdim=True)
    a2 = (dzin * zin).abs().mean(dim=(-2, -1), keepdim=True)
    zmag = zin.abs() + mean.abs() * rstd
    tol_dz = BWD_REL * rstd * (dzin.abs() + a1 + zmag * a2)
    tol_dg = BWD_REL * g32.abs() * zmag
    return tol_dz, tol_dg


def check_bwd_kernels(torch, kernels, seed: int, shapes):
    """Backward kernel against the plain backward computed in f32 from the
    same inputs; dbeta is g cast on the host and is checked exactly."""
    worst = 0.0
    for name, dtypes, zi, gamma, g in bwd_cases(torch, seed, shapes):
        dz, dg, db = kernels.in_modulate_bwd_cuda(zi, gamma, g)
        torch.cuda.synchronize()
        rz, rg, _ = kernels.in_modulate_bwd_plain(zi.float(), gamma.float(),
                                                  g.float())
        tol_dz, tol_dg = bwd_tolerance(torch, zi, gamma, g)
        if zi.dtype == torch.bfloat16:
            tol_dz = tol_dz + bf16_ulps(torch, rz)
        if gamma.dtype == torch.bfloat16:
            tol_dg = tol_dg + bf16_ulps(torch, rg)
        rec = {"phase": "kernel_check_bwd", "kernel": "in_modulate_bwd",
               "block": name, "dtypes": dtypes, "shape": list(zi.shape),
               "tolerance": f"{BF16_ULPS} bf16 ulps of a bf16 output + "
                            f"2^{int(np.log2(BWD_REL))} x the magnitudes "
                            "of its terms"}
        ok = dz.dtype == zi.dtype and dg.dtype == gamma.dtype and bool(
            torch.equal(db, g.to(gamma.dtype)))
        for out_name, got, ref, tol in (("dz", dz, rz, tol_dz),
                                        ("dgamma", dg, rg, tol_dg)):
            err = (got.float() - ref).abs()
            finite = bool(torch.isfinite(got).all())
            within = bool((err <= tol).all())
            ratio = float(torch.where(err == 0, torch.zeros_like(err),
                                      err / tol).max())
            rec[out_name] = {"max_abs_err": float(err.max()),
                             "worst_err_over_tol": ratio, "finite": finite}
            ok = ok and finite and within
            worst = max(worst, float(err.max()))
        rec["ok"] = ok
        emit(rec)
        check(ok, f"in_modulate_bwd disagrees with plain at {name} {dtypes}")
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


def train_batch(rng, cfg):
    """One stacked microbatch [1, ...] of phantoms; contrast 0 is missing
    (zero-filled, mask 0) in the first B // 8 samples."""
    m, b = cfg.modality_num, cfg.batch_size
    x = phantoms(rng, m, b, cfg.input_height, cfg.input_width, cfg.block_ch)
    mask = np.ones((b, m), np.float32)
    x[0, :b // 8] = 0.0
    mask[:b // 8, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    return {"inputs": x[None], "mask": mask[None], "mask_img": mask_img[None]}


def recon_loss(cfg, metrics) -> float:
    return (cfg.lambda_recon_x * metrics["recon_x"]
            + cfg.lambda_recon_x_mix * metrics["recon_x_mix"])


def run_train(torch, kernels, train_mod, model, cfg, batch, pairs, seed):
    """TRAIN_STEPS Adam steps on one batch, the noise of sample_z drawn
    anew from ``seed`` each step, so that only the weights change."""
    from representation_disentanglement_torch.training.optim import (
        make_optimizer)
    opt = make_optimizer(model.parameters(), cfg)
    step = train_mod.make_train_step(model, cfg, opt)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    stats0 = {k: v.clone() for k, v in model.named_buffers()
              if "running" in k}
    history, per_step = [], []
    kernels.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        before = kernels.launch_counts()
        gen.manual_seed(seed)
        history.append(train_mod.metrics_to_dict(
            step(batch, gen, pairs, first_of_epoch=(i == 0))))
        after = kernels.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        if i == 0:
            unreached = [n for n, p in model.named_parameters()
                         if not n.startswith("output_decoder")
                         and not bool(p.grad.abs().max() > 0)]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    unmoved = [k for k, v in model.named_buffers()
               if k in stats0 and torch.equal(v, stats0[k])]
    return step, gen, history, per_step, launches, unreached, unmoved


def grads_of_one_step(torch, train_mod, model, cfg, batch, pair, seed):
    """Losses and gradients (f32, detached) of one train-mode forward."""
    mb = train_mod.prepare_batch({k: v[0] for k, v in batch.items()},
                                 model.device, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = [p for _, p in model.named_parameters()]
    l = train_mod.loss_fn(model, cfg, mb, gen, pair, compute_y=False)
    grads = torch.autograd.grad(l["all"], params, allow_unused=True)
    return ({k: float(v.detach()) for k, v in l.items()},
            [torch.zeros_like(p) if g is None else g.float()
             for p, g in zip(params, grads)])


def compare_kernel_and_plain_step(torch, train_mod, model, cfg, batch, pair,
                                  seed):
    """One step's losses and gradients with the kernels and with the plain
    interior, from the same weights, batch and noise."""
    model.set_use_pallas(True)
    lk, gk = grads_of_one_step(torch, train_mod, model, cfg, batch, pair,
                               seed)
    model.set_use_pallas(False)
    lp, gp = grads_of_one_step(torch, train_mod, model, cfg, batch, pair,
                               seed)
    model.set_use_pallas(True)
    loss_rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30)
                for k in lk if lp[k] != 0.0}
    num = torch.sqrt(sum(((a - b).square().sum() for a, b in zip(gk, gp)),
                         torch.zeros((), device=DEVICE)))
    den = torch.sqrt(sum((b.square().sum() for b in gp),
                         torch.zeros((), device=DEVICE)))
    leaf = [float((a - b).norm() / b.norm().clamp_min(1e-30))
            for a, b in zip(gk, gp) if float(b.norm()) > 0]
    return loss_rel, float(num / den), float(np.median(leaf)), max(leaf)


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

    # 3. kernels against plain: forward at the serving shapes, backward at
    # the training shapes
    cfg = config.flagship()
    tshapes = train_shapes(cfg.modality_num, cfg.batch_size)
    max_err = check_kernels(torch, kernels, args.seed)
    max_err_bwd = check_bwd_kernels(torch, kernels, args.seed, tshapes)

    # 4. the serving path at flagship width
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
    serve_launches = launches
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
    serve_totals = totals

    # 7. the flagship train step: five Adam steps on one batch
    from representation_disentanglement_torch.training import train as T
    batch = train_batch(rng, cfg)
    pairs = T.draw_pairs(np.random.default_rng(args.seed), M, 1)
    per_step_expected = 3 + 3 * M
    (step, tgen, history, per_step, train_launches, unreached,
     unmoved) = run_train(torch, kernels, T, model, cfg, batch, pairs,
                          args.seed)
    recon = [recon_loss(cfg, h) for h in history]
    emit({"phase": "train", "steps": TRAIN_STEPS, "batch": cfg.batch_size,
          "pairs": pairs.tolist(), "metrics": history,
          "recon_loss": recon, "launches_per_step": per_step,
          "launches": train_launches, "unreached_params": unreached,
          "unmoved_bn_stats": unmoved})
    for h in history:
        check(all(np.isfinite(v) for v in h.values()),
              f"non-finite train metrics: {h}")
    check(not unreached, f"parameters without gradient: {unreached[:5]}")
    check(not unmoved, f"BatchNorm statistics that did not move: "
                       f"{unmoved[:5]}")
    total = [h["all"] for h in history]
    check(total[-1] < total[0] and recon[-1] < recon[0],
          f"the loss did not fall from the first step to the last: total "
          f"{total}, reconstruction {recon}")
    for counts in per_step:
        check(counts == {"in_modulate": per_step_expected,
                         "in_modulate_bwd": per_step_expected},
              f"launches per train step {counts}; expected "
              f"{per_step_expected} of each kernel")

    # 8. one step with the kernels against the plain interior
    loss_rel, grad_rel, leaf_med, leaf_max = compare_kernel_and_plain_step(
        torch, T, model, cfg, batch, pairs[0], args.seed)
    emit({"phase": "train_kernel_vs_plain", "dtype": "bf16",
          "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
          "grad_leaf_rel_l2_median": leaf_med, "grad_leaf_rel_l2_max":
              leaf_max, "tolerance": {"loss_rel": TRAIN_BF16_LOSS_REL,
                                      "grad_rel_l2": TRAIN_BF16_GRAD_REL_L2}})
    check(max(loss_rel.values()) <= TRAIN_BF16_LOSS_REL
          and grad_rel <= TRAIN_BF16_GRAD_REL_L2,
          "bf16 train step: kernel and plain interiors disagree")
    small = config.flagship()
    small.input_height, small.input_width = 64, 96
    small.compute_dtype, small.batch_size, small.effective_batch = (
        "float32", 2, 2)
    m32 = build_model(small, device=DEVICE,
                      generator=torch.Generator().manual_seed(args.seed))
    m32.train()
    b32 = train_batch(rng, small)
    loss_rel32, grad_rel32, leaf_med32, leaf_max32 = \
        compare_kernel_and_plain_step(torch, T, m32, small, b32, pairs[0],
                                      args.seed)
    emit({"phase": "train_kernel_vs_plain", "dtype": "f32",
          "input_size": [64, 96], "batch": 2, "loss_rel": loss_rel32,
          "grad_rel_l2": grad_rel32, "grad_leaf_rel_l2_median": leaf_med32,
          "grad_leaf_rel_l2_max": leaf_max32,
          "tolerance": {"loss_rel": TRAIN_F32_LOSS_REL,
                        "grad_rel_l2": TRAIN_F32_GRAD_REL_L2}})
    check(max(loss_rel32.values()) <= TRAIN_F32_LOSS_REL
          and grad_rel32 <= TRAIN_F32_GRAD_REL_L2,
          "f32 train step: kernel and plain interiors disagree")
    del m32

    # 9. timings of the train step and of each launch at training shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_ms = time_ms(torch, lambda: step(batch, tgen, pairs),
                       iters=TRAIN_TIMED_STEPS, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    model.set_use_pallas(False)           # the same step, plain interior
    plain_train_ms = time_ms(torch, lambda: step(batch, tgen, pairs),
                             iters=TRAIN_TIMED_STEPS, warmup=1)
    model.set_use_pallas(True)
    emit({"phase": "train_timing", "card": card, "batch": cfg.batch_size,
          "step_ms": train_ms, "slices_per_s": cfg.batch_size / train_ms
          * 1e3, "peak_mem_gb": peak, "timed_steps": TRAIN_TIMED_STEPS,
          "step_ms_plain_interior": plain_train_ms})

    per_step = {"in_modulate": {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0},
                "in_modulate_bwd": {"ms": 0.0, "plain_ms": 0.0,
                                    "bound_ms": 0.0}}
    bwd_bound_by_ops = False
    for name, dtypes, zi, gamma, g in bwd_cases(torch, args.seed, tshapes):
        if dtypes != "bf16":
            continue
        beta = gamma.clone()
        reps = 1 if name in SHARED_BLOCKS else M     # launches per step
        numel = zi.numel()
        rows = {
            "in_modulate_bwd": (
                lambda: kernels.in_modulate_bwd_cuda(zi, gamma, g),
                lambda: kernels.in_modulate_bwd_plain(zi, gamma, g),
                5 * numel * zi.element_size(),
                IN_MODULATE_BWD_FLOPS_PER_ELEM * numel),
            "in_modulate": (
                lambda: kernels.in_modulate_cuda(zi, gamma, beta),
                lambda: kernels.in_modulate_plain(zi, gamma, beta),
                4 * numel * zi.element_size(),
                IN_MODULATE_FLOPS_PER_ELEM * numel)}
        for kname, (kfn, pfn, nbytes, flops) in rows.items():
            k_ms = time_ms(torch, kfn, iters=50)
            p_ms = time_ms(torch, pfn, iters=20)
            bytes_ms = nbytes / mem_rate * 1e3
            ops_ms = flops / f32_peak * 1e3
            bound = max(bytes_ms, ops_ms)
            if kname == "in_modulate_bwd":
                bwd_bound_by_ops |= ops_ms > bytes_ms
            acc = per_step[kname]
            acc["ms"] += reps * k_ms
            acc["plain_ms"] += reps * p_ms
            acc["bound_ms"] += reps * bound
            emit({"phase": "kernel_timing_bwd" if kname.endswith("bwd")
                  else "kernel_timing_train_fwd", "kernel": kname,
                  "block": name, "shape": list(zi.shape), "card": card,
                  "launches_per_step": reps, "ms": k_ms, "plain_ms": p_ms,
                  "bound_ms": bound, "bytes": nbytes,
                  "bound_share": bound / k_ms, "library_ms": None,
                  "library_note": "no single PyTorch call computes it"})
    del zi, gamma, g, beta

    print(card, flush=True)
    emit({"kernels": [{
        "name": "in_modulate", "route": "cuda",
        "source": "representation_disentanglement_torch/csrc/in_modulate.cu",
        "replaces": "representation_disentanglement_tpu/ops/pallas_kernels.py:172",
        "replaces_also": "representation_disentanglement_tpu/ops/pallas_kernels.py:75",
        "launches": serve_launches["in_modulate"]
                    + train_launches["in_modulate"],
        "launches_by_path": {"serve": serve_launches["in_modulate"],
                             "train": train_launches["in_modulate"]},
        "max_abs_err": max_err, "ms": serve_totals["ms"],
        "plain_ms": serve_totals["plain_ms"],
        "bound_ms": serve_totals["bound_ms"],
        "bound_by": "operations" if bound_by_ops else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes instance-norm "
                        "plus modulation",
        "times_are": "sum over the six SPADE launches of one serve step",
        "train_step": per_step["in_modulate"]}, {
        "name": "in_modulate_bwd", "route": "cuda",
        "source": "representation_disentanglement_torch/csrc/in_modulate.cu",
        "replaces": "representation_disentanglement_tpu/ops/pallas_kernels.py:183",
        "replaces_also": "representation_disentanglement_tpu/ops/pallas_kernels.py:93",
        "launches": train_launches["in_modulate_bwd"],
        "launches_by_path": {"serve": serve_launches["in_modulate_bwd"],
                             "train": train_launches["in_modulate_bwd"]},
        "max_abs_err": max_err_bwd,
        "ms": per_step["in_modulate_bwd"]["ms"],
        "plain_ms": per_step["in_modulate_bwd"]["plain_ms"],
        "bound_ms": per_step["in_modulate_bwd"]["bound_ms"],
        "bound_by": "operations" if bwd_bound_by_ops else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the backward of "
                        "instance-norm plus modulation",
        "times_are": f"sum over the {per_step_expected} backward launches "
                     "of one train step"}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
