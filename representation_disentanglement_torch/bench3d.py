"""Benchmark of the whole-volume 3D path (NVNet3D): the train step
(``training/train3d.make_train_step_3d``) and the eval forward at
``main_3d``'s geometry, on the card (the JAX package's
``tools/bench3d.py``).

Prints one JSON line: volumes/s of each (the best of three windows of
``--steps`` calls, synchronized), the step's ms, its operations (the
convolutions and linear layers of one forward counted from their shapes,
a train step taken as three forwards) and their share of the card's dense
peak for the dtype (``utils/profiling.dense_peak``; null on the CPU and on
a card the table does not know).

``--dtype bfloat16`` (JAX's default) feeds bf16 volumes, as JAX's
``bench_ours`` does: the weights stay f32 and each conv and linear layer
casts its weight to its input's dtype (ops/conv3d.py, as JAX's
``conv3d``), group norm takes f32 statistics and returns the input's
dtype, the losses run in f32, and the VAE's z, drawn with an f32 eps, is
f32, so the decoder after it runs in f32 (JAX's dtype promotion).  Its
share is taken of the bf16 dense peak.

    python -m representation_disentanglement_torch.bench3d [--steps N]
        [--batch B] [--init-channels C] [--dtype bfloat16|float32]
        [--shape H W D] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from representation_disentanglement_torch.utils.profiling import dense_peak


def forward_flop(model, x) -> float:
    """Operations of one eval forward of ``model`` on ``x``: 2 per
    multiply-add of every conv and linear layer, counted from the shapes
    their forward hooks see."""
    from representation_disentanglement_torch.models.layers import (
        TorchLinear)
    from representation_disentanglement_torch.models.unet3d import Conv3d
    total = [0.0]

    def conv(mod, inp, out):
        total[0] += 2.0 * out.numel() * mod.weight[0].numel()

    def linear(mod, inp, out):
        total[0] += 2.0 * out.numel() * mod.weight.shape[1]

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv3d)
                                     else linear)
             for m in model.modules() if isinstance(m, (Conv3d,
                                                        TorchLinear))]
    training = model.training
    model.eval()
    with torch.no_grad():
        model(x)
    model.train(training)
    for h in hooks:
        h.remove()
    return total[0]


def _best_s(fn, steps: int, sync, windows: int = 3) -> float:
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        sync(out)
        best = min(best, time.perf_counter() - t0)
    return best


def bench(shape=(160, 192, 64), in_ch: int = 4, out_ch: int = 3,
          init_ch: int = 16, batch: int = 1, steps: int = 10,
          dtype: str = "float32", device="cuda", seed: int = 0) -> dict:
    from representation_disentanglement_torch.models.unet3d import (
        build_nvnet3d)
    from representation_disentanglement_torch.training.train3d import (
        create_state_3d, make_eval_step_3d, make_train_step_3d)
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    peak = dense_peak(name, dtype)            # raises for another dtype
    model = build_nvnet3d(tuple(shape), in_ch, out_ch, init_ch,
                          device=device,
                          generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    h, w, d = shape
    x = torch.as_tensor(rng.standard_normal((batch, in_ch, h, w, d)),
                        dtype=getattr(torch, dtype), device=device)
    t = torch.as_tensor(rng.integers(0, out_ch + 1,
                                     size=(batch, 1, h, w, d)),
                        dtype=torch.float32, device=device)
    flop = forward_flop(model, x)
    step = make_train_step_3d(model, create_state_3d(model))
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        sync = lambda out: torch.cuda.synchronize(device)
    else:
        sync = lambda out: None
    batch_d = {"inputs": x, "targets": t}
    sync(step(batch_d, gen))                           # first call
    train_s = _best_s(lambda: step(batch_d, gen), steps, sync)
    estep = make_eval_step_3d(model)
    sync(estep(x))
    eval_s = _best_s(lambda: estep(x), steps, sync)
    step_s = train_s / steps
    return {"metric": "train_volumes_per_sec",
            "value": steps * batch / train_s,
            "infer_volumes_per_sec": steps * batch / eval_s,
            "step_ms": step_s * 1e3, "eval_ms": eval_s / steps * 1e3,
            "train_slices_per_sec": steps * batch * d / train_s,
            "flop_per_step": 3.0 * flop, "eval_flop": flop,
            "peak_share": 3.0 * flop / step_s / peak if peak else None,
            "peak": peak,
            "config": f"NVNet3D {h}x{w}x{d} {in_ch}-contrast init_ch "
                      f"{init_ch} batch {batch} {dtype}",
            "device": name,
            "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--init-channels", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--shape", type=int, nargs=3, default=[160, 192, 64],
                    metavar=("H", "W", "D"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = bench(tuple(args.shape), 4, 3, args.init_channels, args.batch,
                args.steps, args.dtype, args.device)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
