"""Where the serve step's or the train step's time goes on the card:
per-stage times and a profiler summary of a flagship path.

Builds the flagship model (configs/brats_4mod.yaml widths: 4 contrasts,
160x192, 7-slice blocks, bf16, fused SPADE interior) with random weights
from ``--seed`` and times, with CUDA events after warm-up:

- serving (default): each stage of ``MultimodalModel.synthesize`` on its
  own (anatomy encoder, modality encoder, shared SPADE half, one not-shared
  half, fused-y output decoder) and the whole serve step;
- training (``--train``): the train-mode forward with the losses, forward
  plus backward, and the whole train step (``make_train_step`` with Adam);
- the whole-volume 3D step (``--volume3d``): NVNet3D at main_3d's
  defaults (4 contrasts, 160x192x64, init 16, batch 1, f32), its
  train-mode forward with ``nvnet_loss``, forward plus backward, the eval
  forward, the train step (``make_train_step_3d``), and the train step
  with ``torch.backends.cudnn.benchmark`` on (cuDNN times its algorithms
  for each convolution and keeps the fastest) and with the model and the
  volume in ``channels_last_3d`` memory;
- then one ``torch.profiler`` window over a few steps: device time by
  kernel name, the device's busy share of the window's wall time, the
  number of device operations per step and the launches of the port's
  kernels per step.

Prints one JSON object per line.  Run on a machine with one CUDA card:

    python -m representation_disentanglement_torch.profile_stages \
        [--batch 16] [--train | --volume3d]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
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


def _profile(step, steps: int, card: str, batch: int, path: str) -> None:
    """One profiler window over ``steps`` calls of ``step``."""
    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        dev = _device_us(evt)
        if dev > 0:
            rows.append((dev, evt.key, evt.count))
    device_us, ops = 0.0, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device_us += evt.device_time if hasattr(evt, "device_time") \
                else evt.cuda_time
            ops += 1
    rows.sort(reverse=True)
    _emit({"phase": "profile", "path": path, "card": card, "batch": batch,
           "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
           "device_ms_per_step": device_us / steps / 1e3,
           "device_busy_share": device_us / wall_us,
           "device_ops_per_step": ops / steps,
           "kernel_launches_per_step": {
               k: v / steps for k, v in kernels.launch_counts().items()}})
    for dev, key, count in rows[:25]:
        _emit({"phase": "top_device_ops", "path": path, "name": key[:120],
               "ms_per_step": dev / steps / 1e3,
               "calls_per_step": count / steps,
               "share": dev / max(device_us, 1e-9)})


def _inputs(cfg, batch: int, seed: int, missing: bool):
    """Random slice blocks with a background band; contrast 0 zero-filled
    and masked out when ``missing``."""
    M, H, W = cfg.modality_num, cfg.input_height, cfg.input_width
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, batch, H, W, cfg.block_ch, generator=g, device="cuda")
    x[:, :, :16] = 0.0
    mask = torch.ones(batch, M, device="cuda")
    if missing:
        x[0] = 0.0
        mask[:, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).float()
    return x, mask, mask_img


def _train(model, cfg, args, card) -> None:
    from representation_disentanglement_torch.training import optim, train
    x, mask, mask_img = _inputs(cfg, args.batch, args.seed, missing=False)
    batch = {"inputs": x[None], "mask": mask[None], "mask_img": mask_img[None]}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    pairs = train.draw_pairs(np.random.default_rng(args.seed),
                             cfg.modality_num, 1)
    step = train.make_train_step(model, cfg, optim.make_optimizer(
        model.parameters(), cfg))
    mb = train.prepare_batch({k: v[0] for k, v in batch.items()}, "cuda",
                             cfg)
    model.train()

    def fwd():
        return train.loss_fn(model, cfg, mb, gen, pairs[0], False)["all"]

    times = {"forward_losses": _ms(fwd, iters=5),
             "forward_backward": _ms(lambda: fwd().backward(), iters=5),
             "train_step": _ms(lambda: step(batch, gen, pairs), iters=5)}
    _emit({"phase": "stages", "path": "train", "card": card,
           "batch": args.batch, "ms": times})
    _profile(lambda: step(batch, gen, pairs), args.steps, card, args.batch,
             "train")


def _volume3d(args, card) -> None:
    from representation_disentanglement_torch.models.unet3d import (
        build_nvnet3d, nvnet_loss)
    from representation_disentanglement_torch.training import train3d
    model = build_nvnet3d(device="cuda", generator=torch.Generator(
        ).manual_seed(args.seed))
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn(1, 4, 160, 192, 64, generator=g, device="cuda")
    t = torch.randint(0, 4, (1, 1, 160, 192, 64), generator=g,
                      device="cuda").float()
    batch = {"inputs": x, "targets": t}
    step = train3d.make_train_step_3d(model, train3d.create_state_3d(model))
    eval_step = train3d.make_eval_step_3d(model)

    def fwd():
        model.train()
        return nvnet_loss(*model(x, g), t, x)[0]

    times = {"forward_loss": _ms(fwd, iters=5),
             "forward_backward": _ms(lambda: fwd().backward(), iters=5),
             "eval_forward": _ms(lambda: eval_step(x), iters=5),
             "train_step": _ms(lambda: step(batch, g), iters=5)}
    torch.backends.cudnn.benchmark = True
    try:
        times["train_step_cudnn_benchmark"] = _ms(lambda: step(batch, g),
                                                  iters=5)
    finally:
        torch.backends.cudnn.benchmark = False
    # the same step with the model and the volume in channels_last_3d
    # memory (the logical layout stays [B, C, H, W, D])
    cl = torch.channels_last_3d
    model.to(memory_format=cl)
    batch_cl = {"inputs": x.contiguous(memory_format=cl), "targets": t}
    times["train_step_channels_last_3d"] = _ms(lambda: step(batch_cl, g),
                                               iters=5)
    times["eval_forward_channels_last_3d"] = _ms(
        lambda: eval_step(batch_cl["inputs"]), iters=5)
    model.to(memory_format=torch.contiguous_format)
    _emit({"phase": "stages", "path": "volume3d", "card": card, "batch": 1,
           "ms": times})
    _profile(lambda: step(batch, g), args.steps, card, 1, "volume3d")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5,
                    help="steps inside the profiler window")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile the train step instead of the serve "
                           "step")
    mode.add_argument("--volume3d", action="store_true",
                      help="profile the whole-volume 3D train step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stages: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    if args.volume3d:
        _volume3d(args, card)
        return 0

    cfg = config.flagship()
    cfg.batch_size = cfg.effective_batch = args.batch
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(args.seed))
    if args.train:
        _train(model, cfg, args, card)
        return 0
    M, B = cfg.modality_num, args.batch
    x, mask, mask_img = _inputs(cfg, B, args.seed, missing=True)
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
    _emit({"phase": "stages", "path": "serve", "card": card, "batch": B,
           "ms": times, "stage_sum_ms": sum(v for k, v in times.items()
                                            if k != "serve_step")})
    _profile(lambda: step(x, mask, mask_img), args.steps, card, B, "serve")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
