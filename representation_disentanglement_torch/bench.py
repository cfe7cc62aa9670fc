"""Benchmark of the flagship configuration on the card: the train step,
the synthesis forward, the serve step and the eval step (the JAX package's
root ``bench.py``), printing its one-line JSON.

    python -m representation_disentanglement_torch.bench [--smoke]
        [--steps N] [--dtype bfloat16|float32] [--pallas/--no-pallas]
        [--fuse-bn/--no-fuse-bn] [--cond-mode grouped|sum_experts]
        [--notshared loop|vmap] [--batch B] [--effective E]
        [--device cuda|cpu]

Configuration: ``make_cfg``, a copy of ``__graft_entry__._make_cfg``: BraTS,
160x192, 7-slice blocks, the four contrasts, CondConv, per-modality
decoder halves, the shipped five losses, batch 16 in one microbatch
(``--smoke``: 32x64, T1 and T2, batch 2, effective 4, 2 steps).  Inputs:
``synthetic_batch``, the same numpy draws in the same order.  Weights:
``build_model`` from a ``torch.Generator`` seeded with ``SEED``.

Each measurement is one warm-up call and the best of three windows of
``--steps`` calls, each window ended by ``torch.cuda.synchronize()``:

- train: ``training.train.make_train_step`` with its Adam, the batch
  stacked ``n_micro`` times, fresh ``draw_pairs`` per call, z drawn from a
  seeded device generator, ``first_of_epoch=False``; ``value`` =
  steps * effective / best seconds;
- infer: the eval-mode forward with the y decodes, z = the mean, no
  latent cycle and no losses, under ``torch.no_grad()``;
- serve: ``serve.make_serve_step(model, cfg, source=0)``;
- val: ``training.evaluate.make_eval_step`` with pair (0, 1) and the y
  decodes.

``flops_per_step`` is counted by ``torch.utils.flop_counter.
FlopCounterMode`` over one whole train step after the warm-up, forward and
backward: every convolution (forward, and ``convolution_backward`` for
the gradients its output mask asks for) and every matrix product (the
resize matrices, CondConv's expert mixing and routing, linear layers), 2
operations per multiply-add.  It does not count the optimizer's
elementwise update, the ``rdt::`` custom ops (instance norm, modulation
and BatchNorm: elementwise work and reductions with no formula there) or
any other elementwise op, so it lies below XLA's ``cost_analysis``, which
counts those too.  ``mfu`` = (flops_per_step / step time) / the card's
dense peak for the compute dtype (``utils/profiling.dense_peak``): null on
the CPU and on a card the table does not know.  ``bytes_per_step``,
``hbm_gbps`` and the baseline fields are null: torch has no counterpart of
XLA's ``bytes accessed``, and the JAX bench's baseline is the torch
reference on a host CPU, which says nothing of a card.

The line before the last gives each kernel's launches per call of each
measurement, from the ops' launch counters.  The kernels are built from
``csrc/`` at first use; a kernel that does not build or launch fails the
bench.  ``--device cpu`` runs the same code on the CPU, where the ``rdt::``
ops take their plain versions and launch nothing; without a card and
without it, the bench exits with status 2.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

SEED = 10                              # weights; the JAX bench's PRNGKey(10)
FLAGSHIP_CONTRASTS = ("T1", "T1c", "T2", "T2_FLAIR")
SMOKE_CONTRASTS = ("T1", "T2")
BATCH_KEYS = ("inputs", "targets", "mask", "mask_img")
MEASUREMENTS = ("train", "infer", "serve", "val")


def make_cfg(height: int, width: int, contrasts, batch_size: int,
             effective_batch: int):
    """The bench's configuration (``__graft_entry__._make_cfg``)."""
    from representation_disentanglement_torch.config import Config
    cfg = Config(
        dataset_name="BraTS", contrast_list=list(contrasts),
        input_height=height, input_width=width, batch_size=batch_size,
        effective_batch=effective_batch, shared_inp_dec=False, is_cond=True,
        others={"mod_enc_s": False, "ana_dec_act": "softmax", "old": False,
                "softmax_remove_mask": True})
    return cfg.derive().validate()


def synthetic_batch(cfg, rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
    """inputs [M, B, H, W, Cb] standard normal, integer targets [B, H, W,
    1] in 0-3, an all-ones mask [B, M] and mask_img [B, H, W] from the zero
    pixels of modality 0: ``__graft_entry__._synthetic_batch``'s, the same
    draws in the same order."""
    rng = rng or np.random.default_rng(0)
    M, B = cfg.modality_num, cfg.batch_size
    H, W = cfg.input_size
    x = rng.normal(size=(M, B, H, W, cfg.block_ch)).astype(np.float32)
    return {
        "inputs": x,
        "targets": rng.integers(0, 4, size=(B, H, W, 1)).astype(np.float32),
        "mask": np.ones((B, M), np.float32),
        "mask_img": (x[0, :, :, :, 0] == 0).astype(np.float32),
    }


def count_flops(fn: Callable[[], object]) -> float:
    """Operations that ``FlopCounterMode`` counts while ``fn()`` runs
    (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_best3(call: Callable[[], object], steps: int,
               device: torch.device):
    """(seconds of the best of three windows of ``steps`` calls, each
    ended by a synchronize, and the last call's result); the JAX bench
    ends each window with a value fetch."""
    best, out = float("inf"), None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = call()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def train_call(model, cfg, batch: Dict[str, np.ndarray], device):
    """``(call, n_micro)``: ``call()`` takes one optimizer step of
    ``make_train_step`` on ``batch`` stacked ``n_micro`` times, with the
    next sim and adv pairs of a ``default_rng(0)`` and z drawn from a
    device generator seeded 0, and returns its metrics."""
    from representation_disentanglement_torch.training.optim import (
        make_optimizer)
    from representation_disentanglement_torch.training.train import (
        draw_pairs, make_train_step)
    step = make_train_step(model, cfg, make_optimizer(model.parameters(),
                                                      cfg))
    n_micro = max(cfg.effective_batch // cfg.batch_size, 1)
    stacked = {k: torch.as_tensor(np.stack([batch[k]] * n_micro),
                                  device=device) for k in BATCH_KEYS}
    gen = torch.Generator(device=device).manual_seed(0)
    pair_rng = np.random.default_rng(0)

    def call():
        sim = draw_pairs(pair_rng, cfg.modality_num, n_micro)
        adv = draw_pairs(pair_rng, cfg.modality_num, n_micro)
        return step(stacked, gen, sim, adv, first_of_epoch=False)

    return call, n_micro


def inference_calls(model, cfg, batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, Callable[[], object]]:
    """The infer, serve and val calls on ``batch`` (module docstring)."""
    from representation_disentanglement_torch import serve
    from representation_disentanglement_torch.training.evaluate import (
        make_eval_step)
    b = {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32

    def infer():
        model.eval()
        with torch.no_grad():
            out = model(b["inputs"].to(dtype), b["mask"], b["mask_img"],
                        None, compute_y=True, latent_cycle=False)
        return out["y_fake_fused"]

    serve_step = serve.make_serve_step(model, cfg, source=0)

    def serve_call():
        model.eval()
        return serve_step(b["inputs"], b["mask"], b["mask_img"])[1]

    eval_step = make_eval_step(model, cfg)[0]
    pair = np.array([0, 1], np.int32)
    return {"infer": infer, "serve": serve_call,
            "val": lambda: eval_step(b, pair, pair, compute_y=True)[2]}


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    ("cpu" on the CPU); raises when ``nvidia-smi`` fails."""
    if device.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[device.index or 0].strip()


def bench_ours(height, width, contrasts, batch_size, effective_batch, steps,
               dtype="bfloat16", use_pallas=True, cond_mode="grouped",
               notshared_impl="loop", fuse_bn=False, device="cuda") -> dict:
    """Build the model and measure the four calls; returns the rates, the
    FLOP count, the final loss and the launches per call."""
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.ops import kernels
    from representation_disentanglement_torch.training.train import (
        metrics_to_dict)
    from representation_disentanglement_torch.utils.profiling import (
        dense_peak)
    device = torch.device(device)
    if device.type == "cuda":            # float32 means float32 (TF32 off)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = make_cfg(height, width, contrasts, batch_size, effective_batch)
    cfg.compute_dtype = dtype
    cfg.use_pallas = use_pallas
    cfg.cond_mode = cond_mode
    cfg.notshared_impl = notshared_impl
    cfg.fuse_bn = fuse_bn
    cfg.validate()
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(SEED))
    batch = synthetic_batch(cfg, np.random.default_rng(0))
    train, n_micro = train_call(model, cfg, batch, device)
    calls = dict(train=train, **inference_calls(model, cfg, batch, device))

    launches, n_calls, seconds = {}, {}, {}
    flops_per_step, metrics = 0.0, None
    for name in MEASUREMENTS:
        call = calls[name]
        kernels.reset_launch_counts()
        call()                                         # warm-up
        _sync(device)
        n_calls[name] = 1
        if name == "train":
            # after the warm-up, as the JAX bench's cost analysis
            flops_per_step = count_flops(call)
            n_calls[name] += 1
        seconds[name], out = time_best3(call, steps, device)
        n_calls[name] += 3 * steps
        launches[name] = kernels.launch_counts()
        if name == "train":
            metrics = out
    per_call = {m: {k: v / n_calls[m] for k, v in launches[m].items()}
                for m in MEASUREMENTS}
    train_sps = steps * effective_batch / seconds["train"]
    step_time = effective_batch / train_sps
    tflops = flops_per_step / step_time / 1e12
    card = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    peak = dense_peak(card, dtype)
    if peak is None and device.type == "cuda":
        print(f"bench: no dense peak of {dtype} for {card!r} in "
              "utils/profiling.DENSE_PEAKS; mfu is null", file=sys.stderr)
    return {"train_sps": train_sps,
            "infer_sps": steps * batch_size / seconds["infer"],
            "serve_sps": steps * batch_size / seconds["serve"],
            "val_sps": steps * batch_size / seconds["val"],
            "final_loss": metrics_to_dict(metrics)["all"] / n_micro,
            "flops_per_step": flops_per_step, "tflops_per_sec": tflops,
            "mfu": tflops * 1e12 / peak if peak else None,
            "n_micro": n_micro, "launches_per_call": per_call,
            "calls": n_calls}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="32x64, T1 and T2, batch 2, effective 4, 2 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--no-baseline", action="store_true",
                    help="accepted for the JAX bench's command line; the "
                         "port measures no baseline")
    ap.add_argument("--pallas", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the SPADE interior through the in_modulate "
                         "kernels (off: its plain version)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--cond-mode", default="grouped",
                    choices=["grouped", "sum_experts"])
    ap.add_argument("--fuse-bn", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="the train-mode BatchNorm through the bn_stats "
                         "and bn_norm kernels")
    ap.add_argument("--notshared", default="loop", choices=["vmap", "loop"])
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="refused: the port does not rematerialize")
    ap.add_argument("--batch", type=int, default=None,
                    help="microbatch size (default 16; --smoke 2)")
    ap.add_argument("--effective", type=int, default=None,
                    help="effective batch by gradient accumulation "
                         "(default 16; --smoke max(4, batch))")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.remat:
        raise ValueError(
            "--remat: the port does not rematerialize (its configs load "
            "without remat; the flagship runs remat: False)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device is available; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        raise SystemExit(2)
    if args.smoke:
        h, w, contrasts = 32, 64, SMOKE_CONTRASTS
        bs = args.batch or 2
        eb = args.effective or max(4, bs)
        steps = args.steps or 2
    else:
        h, w, contrasts = 160, 192, FLAGSHIP_CONTRASTS
        bs, eb = args.batch or 16, args.effective or 16
        steps = args.steps or 20
    r = bench_ours(h, w, contrasts, bs, eb, steps, dtype=args.dtype,
                   use_pallas=args.pallas, cond_mode=args.cond_mode,
                   notshared_impl=args.notshared, fuse_bn=args.fuse_bn,
                   device=device)
    print(json.dumps({"launches_per_call": r["launches_per_call"],
                      "calls": r["calls"]}), flush=True)
    result = {
        "metric": "train_slices_per_sec_per_chip",
        "value": r["train_sps"],
        "unit": "slices/sec/chip",
        "vs_baseline": None,
        "infer_slices_per_sec": r["infer_sps"],
        "val_slices_per_sec": r["val_sps"],
        "serving_slices_per_sec": r["serve_sps"],
        "mfu": r["mfu"],
        "tflops_per_sec": r["tflops_per_sec"],
        "flops_per_step": r["flops_per_step"],
        "bytes_per_step": None,
        "hbm_gbps": None,
        "final_loss": r["final_loss"],
        "config": f"BraTS {len(contrasts)}-modality {h}x{w} batch {bs} "
                  f"(effective {eb}) {args.dtype}"
                  + (" fuse_bn" if args.fuse_bn else "")
                  + ("" if args.pallas else " no-pallas"),
        "device": card_line(device),
        "baseline_train_slices_per_sec": None,
        "baseline_config": "none measured on the card: the JAX bench's "
                           "baseline is the torch reference on a host CPU, "
                           "which compares nothing with a card",
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
