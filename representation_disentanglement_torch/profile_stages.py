"""Where the serve step's time goes on the card: per-stage times and a
profiler summary of the flagship serving path.

Builds the flagship model (configs/brats_4mod.yaml widths: 4 contrasts,
160x192, 7-slice blocks, bf16, fused SPADE interior) with random weights
from ``--seed`` and times, with CUDA events after warm-up:

- each stage of ``MultimodalModel.synthesize`` on its own (anatomy encoder,
  modality encoder, shared SPADE half, one not-shared half, fused-y output
  decoder) and the whole serve step;
- one ``torch.profiler`` window over a few serve steps: device time by
  kernel name, the device's busy share of the window's wall time, and the
  number of kernel launches per step.

Prints one JSON object per line.  Run on a machine with one CUDA card:

    python -m representation_disentanglement_torch.profile_stages [--batch 16]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from representation_disentanglement_torch import config, serve
from representation_disentanglement_torch.models.multimodal import (
    build_model, fuse_anatomy, to_nchw)
from representation_disentanglement_torch.ops import kernels


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
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


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5,
                    help="serve steps inside the profiler window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stages: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]

    cfg = config.flagship()
    cfg.batch_size = args.batch
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(args.seed))
    M, B, H, W = cfg.modality_num, args.batch, cfg.input_height, \
        cfg.input_width
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn(M, B, H, W, cfg.block_ch, generator=g, device="cuda")
    x[:, :, :16] = 0.0                       # background band
    x[0] = 0.0                               # contrast 0 missing
    mask = torch.ones(B, M, device="cuda")
    mask[:, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).float()
    source = 1
    xb = x.to(torch.bfloat16)
    step = serve.make_serve_step(model, cfg, source)

    with torch.inference_mode():
        xf = to_nchw(xb)
        types = model._types()
        sf = model._encode_anatomy(xf, mask_img)
        zf, _ = model._encode_modality(xf)
        s_src = sf[source * B:(source + 1) * B].repeat(M, 1, 1, 1)
        mid = model.input_decoder_list[M](s_src, zf, types)
        fused = fuse_anatomy(sf.view(M, B, *sf.shape[1:]), mask,
                             cfg.fuse_method)
        stages = {
            "anatomy_encoder": lambda: model._encode_anatomy(xf, mask_img),
            "modality_encoder": lambda: model._encode_modality(xf),
            "spade_shared": lambda: model.input_decoder_list[M](
                s_src, zf, types),
            "spade_notshared": lambda: model.input_decoder_list[source](
                s_src, mid, types),
            "output_decoder_fused_y": lambda: model.output_decoder(fused),
        }
        times = {name: _ms(fn) for name, fn in stages.items()}
    times["serve_step"] = _ms(lambda: step(x, mask, mask_img))
    _emit({"phase": "stages", "card": card, "batch": B,
           "ms": times, "stage_sum_ms": sum(v for k, v in times.items()
                                            if k != "serve_step")})

    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(x, mask, mask_img)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    launches = 0
    for evt in prof.key_averages():
        dev = _device_us(evt)
        if dev <= 0:
            continue
        rows.append((dev, evt.key, evt.count))
    device_us = 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device_us += evt.device_time if hasattr(evt, "device_time") \
                else evt.cuda_time
            launches += 1
    rows.sort(reverse=True)
    _emit({"phase": "profile", "card": card, "batch": B, "steps": args.steps,
           "wall_ms_per_step": wall_us / args.steps / 1e3,
           "device_ms_per_step": device_us / args.steps / 1e3,
           "device_busy_share": device_us / wall_us,
           "device_ops_per_step": launches / args.steps,
           "in_modulate_launches_per_step":
               kernels.launch_counts()["in_modulate"] / args.steps})
    for dev, key, count in rows[:25]:
        _emit({"phase": "top_device_ops", "name": key[:120],
               "ms_per_step": dev / args.steps / 1e3,
               "calls_per_step": count / args.steps,
               "share": dev / max(device_us, 1e-9)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
