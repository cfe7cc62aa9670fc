#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (representation_disentanglement_torch).

Drives the port's paths, serving, training (with and without the fused
BatchNorm pass), validation and inference from a trained run (the test
phase, its result dump, z retrieval, the serve CLI), and the whole-volume
3D path (``main_3d``, phases 29-36 below), at the flagship
configuration
(configs/brats_4mod.yaml: 4 contrasts, 160x192, 7-slice blocks, batch 16,
bf16, fused SPADE interior, the shipped five losses) on one CUDA card, with
random weights from ``--seed`` and synthetic brain phantoms made with
numpy:

1. print the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build every CUDA kernel of the paths from ``csrc/`` with ``nvcc``, one
   compiler per source, in parallel;
3. hold the forward kernel against its plain PyTorch version at the shapes
   the serving path gives it, and both kernels against their plain
   versions at the shapes the train step of each configuration below gives
   them (flagship M=4 B=16, stage 2 M=4 B=8, ZeroDose M=2 B=8;
   ``kernel_check``, ``kernel_check_bwd``), and the forward kernel at the
   eval grid of ``test_dropoff``'s short last batch (M=4, B=6);
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
   training shapes beside its bound (``kernel_timing_bwd``);
10. hold the BatchNorm kernels (K6 statistics, K7 normalize) against their
    plain versions at every BatchNorm call of the flagship train step, bf16
    and f32 (``bn_kernel_check``);
11. take three Adam steps of a flagship model with ``fuse_bn`` on, the
    first the first of its epoch (``train_fused_bn``): finite metrics, a
    reconstruction loss lower at the last step than at the first, moved
    statistics, 28 then 16 launches of each BatchNorm kernel per step;
12. compare one step with the fused and with the unfused BatchNorm, at
    flagship bf16 and on a small f32 model (``train_fused_vs_unfused``);
13. run ``training.evaluate.evaluate`` over four validation batches on the
    fused-trained model (``eval``): finite losses, SSIM at most 1, the same
    stat dict from a second call, no BatchNorm kernel launched;
14. a whole training run through ``main_missing.run`` (``train_run``): 8
    phantom subjects at 160x192x155 in memory (5 train, 1 val, 2 test, 32
    slices each), two epochs over the device volume cache in chunks of 4
    steps, validation, the plateau schedule, ``stat.csv`` and checkpoints:
    the cache's bytes, 2 finite train and val rows, the checkpoints load,
    the reconstruction loss falls from epoch 0 to epoch 1, and 15 launches
    of each SPADE kernel per step plus 15 forward launches per val batch;
    its seconds per epoch, slices/s beside ``train_timing``'s, validation
    seconds, checkpoint bytes and save ms, and its peak memory above what
    the earlier phases hold;
15. resume it for a third epoch from ``epoch001.ckpt``
    (``train_run_resume``): every tensor restored, the optimizer's step
    count and the schedule carried on, epoch 2 written;
16. resume again with a guard that asks to stop, polled after the first
    chunk of epoch 3 (``train_run_preempt``): ``preempt.ckpt`` and its
    sidecar tagged with epoch 2, and the resume source picks it;
17. one epoch of the same run with ``device_data_cache`` off, through the
    host ``BatchLoader`` (``train_run_host``, the path of a training fold
    larger than ``device_cache_budget_gb``): its rows in ``stat.csv``, the
    same launches per step and per val batch, its seconds and slices/s;
18. time the eval step (``eval_timing``);
19. time each BatchNorm kernel per shape beside its bound, its plain
    version and the library calls, by CUDA events over back-to-back calls
    and over the replay of a CUDA graph of the calls, without the host's
    time (``bn_kernel_timing``), and the train
    step with the fused and with the unfused BatchNorm
    (``train_timing_fused_bn``).

20. a stage-2 segmentation run (``train_seg_stage2``):
    ``main_missing.run(config.seg_stage2(...))`` resumed from a copy of
    the first run's directory, one epoch (``epochs`` = the restored epoch
    + 2) over the same phantoms and their ``seg`` labels: every tensor but
    the output layer's restored, the optimizer not loaded, the stage-1
    parameters bit-identical after the epoch, the output decoder moved,
    finite y losses, Dice and IoU in the val row, 30 ``in_modulate`` and
    no ``in_modulate_bwd`` launch per step;
21. a ZeroDose run (``train_zerodose``): ``run(config.zerodose())`` for
    two epochs on ZeroDose phantoms (T1, T2-FLAIR, the PET target; dropoff
    on): finite y and x losses, SSIM/PSNR of the fused y, the monitor
    ``recon_y_fused``, 18 + 18 SPADE launches per step;
22. three flagship steps with the s discriminator and the KL
    (``train_adv_kl``), with the z prior off and on and with ``fuse_bn``
    (4 more launches of each BatchNorm kernel per step, the
    discriminator's), and K6/K7 against their plain versions at the
    discriminator's four BatchNorm shapes;
23. the train step of each of these configurations
    (``train_timing_seg_stage2``, ``train_timing_zerodose``,
    ``train_timing_adv``);
24. the test phase on ``train_run``'s directory (``test_phase``):
    ``main_missing.run(phase: test)`` on ``--set test`` with the dump
    recorded in memory (``Recorder``: keys, NCHW row shapes, f32 dtypes,
    rows, finite sums; 64 rows, the stale y rows included), the stat dict
    equal to a plain ``evaluate`` of the same model, 15 launches per
    batch, seconds per batch with the dump and without it, the dump's
    copies per batch (the difference, less the recorder), host bytes per
    batch, peak memory;
25. ``--set train`` into an in-memory z bank (``test_bank``), then
    ``--info nearest_neighbour`` and ``--info mean_src=0`` from it
    (``test_retrieval``, ``test_retrieval_mean``): each retrieved z a bank
    row whose cosine is the CPU maximum's within 1e-5, or the bank mean;
    30 launches per batch;
26. ``--set test_dropoff`` (``test_dropoff``): 2 rows x 11 drop types,
    their masks;
27. ``serve.serve`` over the test fold with T1 missing, plain and with the
    z bank in the CLI's default ``nearest_neighbour`` mode and in ``mean``
    mode (``serve_cli``, ``serve_cli_zbank``, ``serve_cli_zbank_mean``):
    [D, H, W] volumes, 6 launches per step, slices/s with the file writes,
    each retrieved z a bank row whose cosine with the card's query is the
    CPU maximum's within 1e-5 (``serve_cli_zbank_retrieval``), the first
    batch against a direct call of the serve step and the source's
    reconstruction unchanged under either bank (``serve_cli_check``);
28. the test phase on the ZeroDose run's directory
    (``test_phase_zerodose``): the y decoded and dumped at every batch.

The whole-volume 3D path (``main_3d``, NVNet3D, ``training/train3d.py``)
at main_3d's defaults (4 contrasts, an H W D slab of 160x192x64, init 16,
batch 1, f32, dropout and the VAE's sampling) on ``train_run``'s phantoms;
no hand-written kernel lies on it, and each phase checks that none was
launched:

29. five Adam steps on one fixed batch (``train3d``): finite metrics, the
    loss lower at the last step than at the first, a nonzero gradient on
    every parameter; the step's median ms over five after warm-up,
    volumes/s, the share of the f32 peak, peak memory above the earlier
    phases, and the same step with TF32 allowed for cuDNN (a measured line
    only);
30. one deterministic step at 32x32x16 (init 8, 2 contrasts) from the same
    weights on the card and on the CPU (``train3d_card_vs_cpu``): the loss
    terms and each parameter's gradient, against cuDNN's 3D algorithms;
31. one ``accum=2`` step at full width (``train3d_accum``): finite metrics
    and its peak memory;
32. the eval step's ms at full width (``eval3d_timing``);
33. ``main_3d.run`` for two epochs on 5 phantom subjects (3 train, 1 val,
    1 test; ``main3d_run``): two finite ``stat.csv`` rows with ``val_dice``,
    ``epoch000``/``epoch001``/``model_best`` load; seconds and volumes/s per
    epoch, checkpoint bytes and save ms;
34. ``--resume`` for a third epoch (``main3d_resume``): every tensor
    restored, the Adam step count carried on;
35. a fourth epoch with a guard that asks to stop (``main3d_preempt``):
    ``preempt.ckpt`` and its sidecar tagged with epoch 2;
36. ``--phase test`` (``main3d_test``): per-subject Dice and IoU in [0, 1],
    a [64, 160, 192] label volume with labels 0-3, the ``test`` row.

Phases 6, 9 and 19 also time each kernel with the L2 cache flushed before
every launch (``cold_ms``).

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
BN_EPS = 1e-5
# K6 against its plain version (torch's f32 reductions): the error of the
# mean relative to mean|x|, and of the variance relative to mean(x^2), per
# (group, channel).  Both sum up to 122,880 values in f32, in different
# orders; a thread of K6 adds up to 240 values in sequence before a tree of
# 9 levels, which bounds its error by about (240 + 9) 2^-24 = 1.5e-5 of the
# sum of magnitudes
BN_STATS_REL = 4e-5
# K7 against its plain version from the same statistics: 2^-20 of the
# magnitudes of its terms, |x - mean| |rsqrt(var + eps) scale| + |bias|
# (rsqrt, fused multiply-add, order), plus 2 bf16 ulps of a bf16 output
BN_NORM_REL = 2.0 ** -20
BN_OPS_PER_ELEM = 3     # K6: add, multiply, add; K7: subtract, multiply, add
BN_CALLS_FIRST, BN_CALLS = 28, 16      # per train step: first of an epoch
TRAIN_FUSED_STEPS = 3
# one step with the fused against the unfused BatchNorm, from the same
# weights, batch and noise.  bf16: the unfused path rounds its per-channel
# scale and shift to bf16 before the product (ops/norm.batch_norm_apply),
# K7 rounds once, so every BatchNorm output differs by up to a few bf16 ulps;
# the latent-z term (about 1e-4, below the bf16 resolution of the z means)
# is held absolutely, at about one bf16 ulp of those means.  f32: the same
# arithmetic in another order.
FUSED_BF16_LOSS_REL = 3e-2
FUSED_BF16_LATENT_ATOL = 5e-4
FUSED_BF16_GRAD_REL_L2 = 5e-2
FUSED_F32_LOSS_REL = 1e-4
FUSED_F32_GRAD_REL_L2 = 1e-3
EVAL_BATCHES = 4
EVAL_TIMED_STEPS = 10
# the training run: the flagship's widths, cut in data scale only (BraTS
# 2020 has 369 subjects, the flagship trains 50 epochs)
RUN_SUBJECTS = (5, 1, 2)                 # train, val, test
RUN_SLICES = (62, 94)                    # 32 slices around the middle
RUN_DEPTH = 155
RUN_EPOCHS, RUN_CHUNK = 2, 4
RUN_CUTS = ("8 phantom subjects (5 train, 1 val, 2 test) of BraTS 2020's "
            "369, 32 slices each; 2 epochs (3 resumed, a 4th preempted) of "
            "the flagship's 50")
RUN_HOST_CUTS = ("the same 8 phantom subjects; 1 epoch of the flagship's "
                 "50")
# the remaining 2D configurations: seg_stage2 resumes
# train_run's stage-1 directory for one epoch; zerodose trains two epochs
# on ZeroDose phantoms cut like the run above; adv_kl takes three flagship
# steps with the s discriminator and the KL, the prior off and on
ZD_CUTS = ("8 ZeroDose phantom subjects (5 train, 1 val, 2 test) at "
           "160x192x155, 32 slices each; 2 epochs of the config's 50")
STAGE2_CUTS = ("train_run's 8 phantom subjects; one epoch (epochs = the "
               "restored epoch + 2) of the config's 50")
ADV_STEPS = 3
ADV_LOSSES = dict(lambda_adv_s=0.1, lambda_kl=0.01)
# the discriminator's BatchNorm inputs [G, B, C, H, W] at the flagship's
# B=16: the pair of modalities as G=2, stages 2-5 at 160x192 / 4 ... / 32
D_BN_SHAPES = [(2, 16, 32, 40, 48), (2, 16, 64, 20, 24),
               (2, 16, 128, 10, 12), (2, 16, 64, 5, 6)]
# inference from the trained run (test phase, retrieval, dropoff, serve CLI)
TEST_CUTS = ("train_run's trained directory: its test fold (2 phantom "
             "subjects, 32 slices each) for --set test, its train fold (5 "
             "subjects) for the bank")
DROP_TYPES_M4 = 11                   # 1 + M + M(M-1)/2 drop types at M=4
DROP_ROWS = 2 * DROP_TYPES_M4        # test_dropoff: 2 selected rows
RETRIEVAL_COS_ATOL = 1e-5            # the chosen row's cosine within this
                                     # of the CPU maximum (f32 on two
                                     # devices)
MEAN_Z_ATOL = 1e-6                   # the bank mean, card against CPU
SERVE_CLI_REL_L2 = 1e-5              # the CLI's volumes against a direct
                                     # call of the serve step
# the whole-volume 3D path (main_3d) at its defaults: BraTS, 4 contrasts,
# an H W D slab of 160x192x64 (depth [45:45+64]), init_channels 16, batch 1,
# f32, dropout 0.2 and the VAE's sampling; its volumes are train_run's
# phantoms
VOL_HWD = (160, 192, 64)
VOL_INIT = 16
VOL_STEPS, VOL_TIMED_STEPS = 5, 5
VOL_LR = 1e-4
# the forward's operations at these defaults, counted from the layer
# shapes (U-Net 277.5 GFLOP, VAE branch 109.0); a train step is about
# three forwards
VOL_FWD_FLOP = 386.5e9
VOL_TRAIN_FLOP = 3 * VOL_FWD_FLOP
VOL_SMALL_HWD, VOL_SMALL_INIT, VOL_SMALL_M = (32, 32, 16), 8, 2
# one small f32 step (generator None) on the card and on the CPU from the
# same weights: the loss terms, and each parameter's gradient as a relative
# L2 gap; the biases that a GroupNorm of one channel per group cancels
# (conv1 of the width-8 blocks) have a gradient of zero up to rounding and
# are held against the largest gradient entry instead
VOL_CARD_CPU_LOSS_REL = 1e-4
VOL_CARD_CPU_GRAD_REL_L2 = 1e-3
# the KL term sums exp(lv) - 1 - lv at |lv| of about 1e-2 (about 5e-5 per
# entry from terms near 1): an f32 rounding of exp(lv) is 2e-3 of an entry
VOL_CARD_CPU_KL_REL = 1e-2
VOL_RUN_SUBJECTS = (3, 1, 1)             # train, val, test
VOL_RUN_EPOCHS = 2
VOL_RUN_CUTS = ("5 of train_run's phantom subjects (3 train, 1 val, 1 "
                "test) of BraTS 2020's 369; 2 epochs (a 3rd resumed, a 4th "
                "preempted) of main_3d's 10")
# written before each cold-L2 launch, outside the timed window; larger than
# the H100's 50 MB L2, and long enough on the card (about 80 us) that the
# launch behind it is queued before the window opens
L2_FLUSH_BYTES = 256 * 2**20
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


def cold_ms(torch, fn, iters: int = 20) -> float:
    """Time of one call of ``fn`` with the L2 cache cold: a buffer of
    L2_FLUSH_BYTES is written before each call, outside the CUDA events
    around the call; the mean over ``iters`` calls."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sum(start.elapsed_time(end) for start, end in pairs) / iters
    del flush
    return ms


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, whose replay is timed with CUDA events, so that the host's time
    per call drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    check(ms > 0, "a CUDA graph replay took no time")
    return ms


def kernel_cases(torch, seed: int, shapes=None):
    """(label, dtypes, zi, gamma, beta) at every SPADE shape of the serving
    path (bf16, N = 64), one f32 shape, and both mixed-dtype pairings; or,
    given ``shapes`` (``train_shapes``), at each of those in bf16."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def mk(c, h, w, zd, gd, n=64):
        shape = (n, c, h, w)
        zi = (3.0 + 2.0 * torch.randn(shape, generator=g, device=DEVICE)
              ).to(zd)
        gamma = (0.5 * torch.randn(shape, generator=g, device=DEVICE)).to(gd)
        beta = (0.5 * torch.randn(shape, generator=g, device=DEVICE)).to(gd)
        return zi, gamma, beta

    bf, f32 = torch.bfloat16, torch.float32
    if shapes is not None:
        for name, n, c, h, w in shapes:
            yield (name, "bf16") + mk(c, h, w, bf, bf, n)
        return
    for name, c, h, w in SPADE_SHAPES:
        yield (name, "bf16") + mk(c, h, w, bf, bf)
    yield ("sp4", "f32") + mk(128, 40, 48, f32, f32)
    yield ("sp5", "bf16-zi/f32-gamma") + mk(64, 80, 96, bf, f32)
    yield ("sp1", "f32-zi/bf16-gamma") + mk(128, 5, 6, f32, bf)


def check_kernels(torch, kernels, seed: int, shapes=None):
    """Kernel against plain (computed in f32 from the same inputs), at the
    shapes of ``kernel_cases``."""
    worst = 0.0
    for name, dtypes, zi, gamma, beta in kernel_cases(torch, seed, shapes):
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


def run_train(torch, kernels, train_mod, model, cfg, batch, pairs, seed,
              steps: int = TRAIN_STEPS):
    """``steps`` Adam steps on one batch, the first the first of its epoch,
    the noise of sample_z drawn anew from ``seed`` each step, so that only
    the weights change."""
    from representation_disentanglement_torch.training.optim import (
        make_optimizer)
    opt = make_optimizer(model.parameters(), cfg)
    step = train_mod.make_train_step(model, cfg, opt)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    stats0 = {k: v.clone() for k, v in model.named_buffers()
              if "running" in k}
    history, per_step = [], []
    kernels.reset_launch_counts()
    for i in range(steps):
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


def compare_one_step(torch, train_mod, model, cfg, batch, pair, seed,
                     toggle):
    """One step's losses and gradients with ``toggle(True)`` and
    ``toggle(False)`` (e.g. ``model.set_use_pallas``), from the same
    weights, batch and noise; ends with ``toggle(True)``.  Returns the
    relative and absolute loss gaps, the gradients' relative L2 gap, and the
    median and largest gap of one leaf."""
    toggle(True)
    lk, gk = grads_of_one_step(torch, train_mod, model, cfg, batch, pair,
                               seed)
    toggle(False)
    lp, gp = grads_of_one_step(torch, train_mod, model, cfg, batch, pair,
                               seed)
    toggle(True)
    loss_rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30)
                for k in lk if lp[k] != 0.0}
    loss_abs = {k: abs(lk[k] - lp[k]) for k in lk}
    num = torch.sqrt(sum(((a - b).square().sum() for a, b in zip(gk, gp)),
                         torch.zeros((), device=DEVICE)))
    den = torch.sqrt(sum((b.square().sum() for b in gp),
                         torch.zeros((), device=DEVICE)))
    leaf = [float((a - b).norm() / b.norm().clamp_min(1e-30))
            for a, b in zip(gk, gp) if float(b.norm()) > 0]
    return (loss_rel, loss_abs, float(num / den), float(np.median(leaf)),
            max(leaf))


def bn_calls(torch, train_mod, model, cfg, batch, pair):
    """(module name, G, B, C, H, W) of every train-mode BatchNorm call of one
    first-of-epoch train forward (the y decodes and the latent cycle), in
    call order.  Updates the model's running statistics."""
    from representation_disentanglement_torch.models.layers import (
        BatchNormTorch)
    calls, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNormTorch):
            def pre(_, args, name=name):
                x, g = args[0], (args[1] if len(args) > 1 else 1)
                calls.append((name, g, x.shape[0] // g) + tuple(x.shape[1:]))
            hooks.append(mod.register_forward_pre_hook(pre))
    mb = train_mod.prepare_batch({k: v[0] for k, v in batch.items()},
                                 model.device, cfg)
    model.train()
    try:
        with torch.no_grad():
            train_mod.loss_fn(model, cfg, mb, None, pair, compute_y=True)
    finally:
        for h in hooks:
            h.remove()
    return calls


def bn_case(torch, shape, dtype, seed: int):
    """(x [G, B, C, H, W] in ``dtype``, scale [C] and bias [C] in f32) on the
    card, with per-channel offsets and spreads like a convolution's
    output."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    c = shape[2]
    rnd = lambda *s: torch.randn(s, generator=gen, device=DEVICE)
    ch = lambda t: t.view(1, 1, c, 1, 1)
    spread = 0.5 + 1.5 * torch.rand(c, generator=gen, device=DEVICE)
    x = (ch(rnd(c)) + ch(spread) * rnd(*shape)).to(dtype)
    return x, 1.0 + 0.5 * rnd(c), 0.5 * rnd(c)


def bn_errors(torch, fused_bn, x, scale, bias, got):
    """K6's (mean, var) and K7's y, normalized from the plain statistics,
    against the plain versions on the same inputs (tolerances at
    BN_STATS_REL and BN_NORM_REL)."""
    mean, var, y = got
    rmean, rvar = fused_bn.bn_stats_plain(x)
    x32 = x.float()
    dims = (1, 3, 4)
    mean_rel = float(((mean - rmean).abs() / x32.abs().mean(dims)).max())
    var_rel = float(((var - rvar).abs() / x32.square().mean(dims)).max())
    ry = fused_bn.bn_norm_plain(x32, rmean, rvar, scale, bias, BN_EPS)
    ch = lambda t: t.reshape(-1, 1, t.shape[-1], 1, 1)
    a = torch.rsqrt(rvar + BN_EPS) * scale
    tol = BN_NORM_REL * ((x32 - ch(rmean)).abs() * ch(a).abs()
                         + ch(bias).abs())
    if x.dtype == torch.bfloat16:
        tol = tol + bf16_ulps(torch, ry)
    err = (y.float() - ry).abs()
    finite = all(bool(torch.isfinite(t).all()) for t in (mean, var, y))
    ratio = float(torch.where(err == 0, torch.zeros_like(err),
                              err / tol).max())
    ok = (finite and y.dtype == x.dtype and mean_rel <= BN_STATS_REL
          and var_rel <= BN_STATS_REL and ratio <= 1.0)
    return {"mean_err_rel_mean_abs_x": mean_rel,
            "var_err_rel_mean_x2": var_rel,
            "stats_max_abs_err": max(float((mean - rmean).abs().max()),
                                     float((var - rvar).abs().max())),
            "y_max_abs_err": float(err.max()), "y_worst_err_over_tol": ratio,
            "finite": finite, "ok": ok}


def bn_norm_from_plain_stats(fused_bn, x, scale, bias):
    """(K6's mean, var, K7's y from the plain statistics)."""
    mean, var = fused_bn.bn_stats_cuda(x)
    rmean, rvar = fused_bn.bn_stats_plain(x)
    return mean, var, fused_bn.bn_norm_cuda(x, rmean, rvar, scale, bias,
                                            BN_EPS)


def eval_batches(rng, cfg, n: int):
    """n validation batches in the in-memory loader contract; contrast 0 is
    missing in the first B // 8 samples of each (as in ``train_batch``)."""
    out = []
    for _ in range(n):
        b = {k: v[0] for k, v in train_batch(rng, cfg).items()}
        b["targets"] = np.zeros(b["mask_img"].shape + (1,), np.float32)
        out.append(b)
    return out


def train_run_data(seed: int, cfg, data_path: str):
    """The run's volumes in memory (a ``VolumeStore``) and its fold txts
    under ``data_path``."""
    from representation_disentanglement_torch.data import synthetic
    from representation_disentanglement_torch.data.dataset import (
        VolumeStore, fold_txt_names)
    vols, subjects, _ = synthetic.synthetic_volumes(
        "BraTS", cfg.contrast_list, "z-score", sum(RUN_SUBJECTS),
        (cfg.input_height, cfg.input_width, RUN_DEPTH), seed)
    n_train, n_val, _ = RUN_SUBJECTS
    synthetic.write_fold_txts(
        data_path, fold_txt_names("BraTS", cfg.fold, cfg.modality_num),
        (subjects[:n_train], subjects[n_train:n_train + n_val],
         subjects[n_train + n_val:]), RUN_SLICES)
    return VolumeStore(data=vols)


def read_stat_csv(path: str):
    """[(info, {key: value})] of a stat.csv; an empty field is NaN."""
    import csv
    with open(path, newline="") as f:
        head, *rows = list(csv.reader(f))
    return [(r[1], {k: float(v) if v else float("nan")
                    for k, v in zip(head[2:], r[2:])}) for r in rows]


def train_run_phases(torch, kernels, seed: int, card: str, per_step: int,
                     train_sps: float) -> dict:
    """Phases ``train_run``, ``train_run_resume``, ``train_run_preempt``,
    ``train_run_host``, ``train_seg_stage2`` and ``test_phases``'s: a
    training run through ``main_missing.run`` on the device volume cache,
    its resume, a preemption, one epoch over the host loader, a stage-2 run
    resumed from the first run's directory, and inference from that
    directory.  Returns the kernel launches of the first run (two epochs),
    of the host-loader run, of stage 2 and of each inference path, and the
    run's in-memory volumes (the 3D phases reuse them)."""
    import os
    import shutil
    import tempfile
    from representation_disentanglement_torch import config, main_missing
    from representation_disentanglement_torch.training import checkpoint
    from representation_disentanglement_torch.utils import preempt

    def run_cfg(data_path, **kw):
        cfg = config.flagship()
        cfg.seed, cfg.data_path = seed, data_path
        cfg.epochs, cfg.epoch_chunk_steps = RUN_EPOCHS, RUN_CHUNK
        for k, v in kw.items():
            setattr(cfg, k, v)
        return cfg

    tmp = tempfile.mkdtemp(prefix="rdt_train_run_")
    try:
        cfg = run_cfg(tmp)
        t0 = time.perf_counter()
        store = train_run_data(seed, cfg, tmp)
        data_s = time.perf_counter() - t0
        n_train, n_val, _ = RUN_SUBJECTS
        n_slices = RUN_SLICES[1] - RUN_SLICES[0]
        steps = n_train * n_slices // cfg.batch_size
        val_batches = -(-n_val * n_slices // cfg.batch_size)
        expect_cache = (sum(RUN_SUBJECTS) * cfg.modality_num * RUN_DEPTH
                        * cfg.input_height * cfg.input_width * 2)
        root = os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()      # the earlier phases'
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = main_missing.run(cfg, ckpt_root=root, store=store,
                               device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        d = out["ckpt_path"]
        rows = read_stat_csv(os.path.join(d, "stat.csv"))
        loaded = {name: checkpoint.load_checkpoint(d, name)["epoch"]
                  for name in ("epoch000.ckpt", "epoch001.ckpt",
                               "model_best.ckpt")}
        epochs = out["epochs"]
        recon = [recon_loss(cfg, r["train"]) for r in epochs]
        emit({"phase": "train_run", "card": card, "cuts": RUN_CUTS,
              "data_s": data_s, "loader": out["loader"],
              "cache_bytes": out["cache_bytes"], "wall_s": wall,
              "epochs": [{"epoch": r["epoch"], "steps": r["steps"],
                          "train_s": r["train_s"],
                          "slices_per_s": r["slices_per_s"],
                          "val_s": r["val_s"], "ckpt_bytes": r["ckpt_bytes"],
                          "ckpt_save_ms": r["ckpt_save_s"] * 1e3,
                          "recon_loss": rc, "monitor": r["monitor"],
                          "is_best": r["is_best"]}
                         for r, rc in zip(epochs, recon)],
              "train_timing_slices_per_s": train_sps,
              "stat_rows": [info for info, _ in rows],
              "checkpoint_epochs": loaded, "run_peak_mem_gb": peak,
              "allocated_before_gb": before / 1e9, "launches": launches})
        check(out["loader"] == "device" and out["cache_bytes"] ==
              expect_cache, f"the device cache path was not taken as "
              f"expected: {out['loader']}, {out['cache_bytes']} bytes")
        check([info for info, _ in rows] == ["epoch[ 0]", "val",
                                             "epoch[ 1]", "val"],
              f"stat.csv rows {[info for info, _ in rows]}")
        check(all(np.isfinite(v) for _, r in rows for v in r.values()),
              f"non-finite stat.csv values: {rows}")
        check([r["steps"] for r in epochs] == [steps] * RUN_EPOCHS,
              f"steps per epoch {[r['steps'] for r in epochs]}")
        check(loaded["epoch000.ckpt"] == 0 and loaded["epoch001.ckpt"] == 1,
              f"checkpoint epochs {loaded}")
        check(recon[1] < recon[0], f"the train reconstruction loss did not "
                                   f"fall from epoch 0 to 1: {recon}")
        n_steps = steps * RUN_EPOCHS
        want = {"in_modulate": per_step * (n_steps + val_batches
                                           * RUN_EPOCHS),
                "in_modulate_bwd": per_step * n_steps,
                "bn_stats": 0, "bn_norm": 0}
        check(launches == want, f"launches in the run {launches}; expected "
                                f"{want}")

        # resume for a third epoch from epoch001.ckpt
        label = os.path.basename(d)
        resumed = run_cfg(tmp, continue_train=True, ckpt_timelabel=label,
                          ckpt_name="epoch001.ckpt", load_yaml=False,
                          epochs=RUN_EPOCHS + 1)
        e1 = checkpoint.load_checkpoint(d, "epoch001.ckpt")
        kernels.reset_launch_counts()
        out_r = main_missing.run(resumed, ckpt_root=root, store=store,
                                 device=DEVICE)
        launches_r = kernels.launch_counts()
        e2 = checkpoint.load_checkpoint(d, "epoch002.ckpt")
        step_of = lambda c: float(c["opt_state"]["state"][0]["step"])
        rows_r = read_stat_csv(os.path.join(d, "stat.csv"))
        emit({"phase": "train_run_resume", "resume_name":
              out_r["resume_name"], "restored": out_r["restored"],
              "start_epoch": out_r["start_epoch"],
              "scheduler_at_start": out_r["scheduler_at_start"],
              "scheduler_saved": e1["scheduler"],
              "optimizer_step": [step_of(e1), step_of(e2)],
              "epochs": [{"epoch": r["epoch"], "train_s": r["train_s"],
                          "slices_per_s": r["slices_per_s"]}
                         for r in out_r["epochs"]],
              "launches": launches_r})
        n_res, n_tot = out_r["restored"]
        check(n_res == n_tot > 0, f"restored {n_res} of {n_tot} tensors")
        check(out_r["start_epoch"] == 1 and [r["epoch"] for r in
                                              out_r["epochs"]] == [2],
              "the resumed run did not run exactly epoch 2")
        check(out_r["scheduler_at_start"] == e1["scheduler"],
              "the schedule was not restored")
        check(step_of(e1) == n_steps and step_of(e2) == n_steps + steps,
              f"optimizer steps {step_of(e1)}, {step_of(e2)}")
        check(e2["epoch"] == 2 and len(rows_r) == 6,
              "epoch 2 was not written")
        check(launches_r["in_modulate_bwd"] == per_step * steps,
              f"launches in the resumed run {launches_r}")

        # resume once more with a guard that asks to stop: the run polls it
        # after the first chunk of epoch 3
        guard = preempt.PreemptionGuard()
        guard.request()
        again = run_cfg(tmp, continue_train=True, ckpt_timelabel=label,
                        ckpt_name="epoch002.ckpt", load_yaml=False,
                        epochs=RUN_EPOCHS + 2)
        out_p = main_missing.run(again, ckpt_root=root, store=store,
                                 device=DEVICE, guard=guard)
        with open(preempt.preempt_path(d) + ".epoch") as f:
            tag = f.read()
        name, pre = preempt.latest_resume_checkpoint(d, "model_best.ckpt")
        emit({"phase": "train_run_preempt", "record": out_p["epochs"],
              "sidecar": tag, "resume_source": name,
              "preempt_epoch": pre["epoch"],
              "optimizer_step": step_of(pre)})
        check(out_p["epochs"] == [{"epoch": 3, "preempted_after_steps":
                                   RUN_CHUNK, "steps": steps}],
              f"the preempted run: {out_p['epochs']}")
        check(tag == "2" and pre["epoch"] == 2
              and name == preempt.PREEMPT_NAME,
              f"preempt sidecar {tag!r}, epoch {pre['epoch']}, resume "
              f"source {name}")
        check(step_of(pre) == n_steps + steps + RUN_CHUNK,
              f"preempt.ckpt's optimizer step {step_of(pre)}")

        # the host loader's path, which the run takes when the volumes
        # exceed device_cache_budget_gb (a real BraTS training fold does)
        host = run_cfg(tmp, device_data_cache=False, epochs=1)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out_h = main_missing.run(host, ckpt_root=os.path.join(tmp, "host"),
                                 store=store, device=DEVICE)
        torch.cuda.synchronize()
        wall_h = time.perf_counter() - t0
        launches_h = kernels.launch_counts()
        rows_h = read_stat_csv(os.path.join(out_h["ckpt_path"], "stat.csv"))
        rec = out_h["epochs"][0] if out_h["epochs"] else {}
        emit({"phase": "train_run_host", "card": card,
              "cuts": RUN_HOST_CUTS,
              "loader": out_h["loader"], "wall_s": wall_h,
              "prefetch_depth": host.prefetch_depth,
              "epochs": [{"epoch": r["epoch"], "steps": r["steps"],
                          "train_s": r["train_s"],
                          "slices_per_s": r["slices_per_s"],
                          "val_s": r["val_s"],
                          "ckpt_save_ms": r["ckpt_save_s"] * 1e3,
                          "recon_loss": recon_loss(host, r["train"])}
                         for r in out_h["epochs"]],
              "device_cache_slices_per_s": [r["slices_per_s"]
                                            for r in epochs],
              "train_timing_slices_per_s": train_sps,
              "stat_rows": [info for info, _ in rows_h],
              "launches": launches_h})
        check(out_h["loader"] == "host" and out_h["cache_bytes"] == 0,
              f"the host loader path was not taken: {out_h['loader']}")
        check([info for info, _ in rows_h] == ["epoch[ 0]", "val"]
              and all(np.isfinite(v) for _, r in rows_h
                      for v in r.values()),
              f"host-loader stat.csv rows {rows_h}")
        check(rec.get("steps") == steps, f"host-loader epoch {rec}")
        want_h = {"in_modulate": per_step * (steps + val_batches),
                  "in_modulate_bwd": per_step * steps,
                  "bn_stats": 0, "bn_norm": 0}
        check(launches_h == want_h, f"launches in the host-loader run "
                                    f"{launches_h}; expected {want_h}")
        launches_s2 = seg_stage2_phase(torch, kernels, card, seed, store, d,
                                       tmp)
        launches_t = test_phases(torch, kernels, card, store, tmp, d, root,
                                 run_cfg)
        return launches, launches_h, launches_s2, launches_t, store
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class Recorder:
    """The in-memory stand-in for the ``results_all.h5`` writer
    (``evaluate(writer=...)``): per key the shape of one row, the dtype, the
    rows, the bytes and a float64 sum, not the arrays, except for the keys
    in ``keep``; ``seconds`` is its own host time."""

    def __init__(self, keep=()):
        self.keys, self.kept = {}, {k: [] for k in keep}
        self.path, self.closed, self.seconds = None, False, 0.0

    def __call__(self, path):                  # the writer factory
        self.path = path
        return self

    def append(self, key, arr):
        t0 = time.perf_counter()
        arr = np.asarray(arr)
        rec = self.keys.setdefault(key, {"shape": list(arr.shape[1:]),
                                         "dtype": str(arr.dtype), "rows": 0,
                                         "bytes": 0, "sum": 0.0})
        check(rec["shape"] == list(arr.shape[1:])
              and rec["dtype"] == str(arr.dtype),
              f"dump key {key}: rows of {arr.shape[1:]} {arr.dtype} after "
              f"{rec['shape']} {rec['dtype']}")
        rec["rows"] += arr.shape[0]
        rec["bytes"] += arr.nbytes
        if arr.dtype.kind == "f":
            rec["sum"] += float(np.add.reduce(arr, axis=None,
                                              dtype=np.float64))
        if key in self.kept:
            self.kept[key].append(arr)
        self.seconds += time.perf_counter() - t0

    def close(self):
        self.closed = True

    def array(self, key):
        return np.concatenate(self.kept[key])

    def summary(self):
        return {k: {"shape": r["shape"], "dtype": r["dtype"],
                    "rows": r["rows"], "sum": r["sum"]}
                for k, r in self.keys.items()}

    def nbytes(self):
        return sum(r["bytes"] for r in self.keys.values())


def dump_layout(cfg, retrieval: bool = False,
                slice_dtype: str = "int32") -> dict:
    """The row shape and dtype of each dumped key (JAX evaluate.py:
    306-340) for ``cfg``'s widths, NCHW; ``slice_idx`` is int32 from the
    device loader, int64 from the host one, as in the JAX package."""
    M, H, W = cfg.modality_num, cfg.input_height, cfg.input_width
    cb, cs, co = cfg.block_ch, cfg.s_num_ch, cfg.out_num_ch
    f32 = "float32"
    want = {"inputs": ([M * cb, H, W], f32), "targets": ([1, H, W], f32),
            "mask": ([M], f32), "slice_idx": ([], slice_dtype),
            "y_fake_fused": ([co, H, W], f32),
            "y_fake_list": ([M, co, H, W], f32),
            "xi_fake_list": ([M, cb, H, W], f32),
            "xi_fake_mix": ([M * (M - 1), cb, H, W], f32),
            "s_list": ([M, cs, H, W], f32), "z_list": ([M, cfg.z_size], f32)}
    if retrieval:
        want["z_list_find_all"] = ([M, cfg.z_size], f32)
    return want


def check_dump(rec: Recorder, cfg, rows: int, y_rows: int, what: str,
               retrieval: bool = False, slice_dtype: str = "int32") -> None:
    """Keys, row shapes, dtypes, rows and finite sums of a recorded dump;
    ``subj_id`` is a bytes column of ``rows``."""
    want = dump_layout(cfg, retrieval, slice_dtype)
    got = rec.summary()
    check(rec.closed and sorted(got) == sorted(list(want) + ["subj_id"]),
          f"{what}: dumped keys {sorted(got)}")
    for k, (shape, dtype) in want.items():
        check(got[k]["shape"] == shape and got[k]["dtype"] == dtype,
              f"{what}: {k} rows of {got[k]['shape']} {got[k]['dtype']}, "
              f"expected {shape} {dtype}")
        n = y_rows if k.startswith("y_fake") else rows
        check(got[k]["rows"] == n, f"{what}: {k} has {got[k]['rows']} rows, "
                                   f"expected {n}")
        check(np.isfinite(got[k]["sum"]), f"{what}: {k} not finite")
    check(got["subj_id"]["rows"] == rows
          and got["subj_id"]["dtype"].startswith("|S"),
          f"{what}: subj_id {got['subj_id']}")


def test_phases(torch, kernels, card: str, store, data_path: str,
                run_dir: str, root: str, run_cfg) -> dict:
    """Phases ``test_phase``, ``test_bank``, ``test_retrieval``,
    ``test_dropoff``, ``serve_cli`` and ``serve_cli_zbank``: inference from
    the trained run directory ``run_dir`` (under ``root``, its data under
    ``data_path``) through ``main_missing.run(phase: test)`` and
    ``serve.serve``, with the dump recorded in memory (``Recorder``) and the
    z bank in memory.  ``main_missing.evaluate`` is timed meanwhile.
    Returns the kernel launches of each path."""
    from representation_disentanglement_torch import main_missing
    evaluate, eval_s = main_missing.evaluate, []

    def timed_evaluate(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(*a, **kw)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
        return out

    main_missing.evaluate = timed_evaluate
    try:
        return _test_phases(torch, kernels, card, store, data_path, run_dir,
                            root, run_cfg, eval_s)
    finally:
        main_missing.evaluate = evaluate


def _test_phases(torch, kernels, card, store, data_path, run_dir, root,
                 run_cfg, eval_s) -> dict:
    import os
    import tempfile
    from representation_disentanglement_torch import losses, main_missing
    from representation_disentanglement_torch import serve
    from representation_disentanglement_torch.config import resolve_run
    from representation_disentanglement_torch.data.dataset import DataAll
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    label = os.path.basename(run_dir)
    cfg = run_cfg(data_path, phase="test", ckpt_timelabel=label)
    launches = {}

    def test_run(path, eval_set, **kw):
        rec = kw.setdefault("writer", Recorder())
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stat = main_missing.run(run_cfg(data_path, phase="test",
                                        ckpt_timelabel=label),
                                ckpt_root=root, store=store, device=DEVICE,
                                eval_set=eval_set, **kw)
        torch.cuda.synchronize()
        launches[path] = kernels.launch_counts()
        return stat, rec, time.perf_counter() - t0

    B, M = cfg.batch_size, cfg.modality_num
    _, _, n_test = RUN_SUBJECTS
    n_slices = RUN_SLICES[1] - RUN_SLICES[0]
    test_rows = n_test * n_slices
    test_batches = -(-test_rows // B)
    per_batch = 3 + 3 * M                     # K1 per eval step
    # test_phase: --set test with the dump, and the same model's plain
    # evaluate (no dump) for the stat dict and the eval time alone
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stat, rec, wall = test_run("test_phase", "test")
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    dump_s = eval_s[-1]
    rcfg = resolve_run(run_cfg(data_path, phase="test",
                               ckpt_timelabel=label), root).derive()
    model = build_model(rcfg, device=DEVICE)
    main_missing._restore(model, rcfg, rcfg.ckpt_name)
    loaders = main_missing.make_loaders(rcfg, DEVICE, store)
    plain = main_missing.evaluate(model, rcfg, loaders[2])
    plain_s = eval_s[-1]
    same = sorted(stat) == sorted(plain) and all(
        np.isclose(stat[k], plain[k], rtol=1e-6, atol=0.0, equal_nan=True)
        or stat[k] == plain[k] for k in plain)
    emit({"phase": "test_phase", "card": card, "cuts": TEST_CUTS,
          "set": "test", "batch": B, "batches": test_batches,
          "keys": rec.summary(), "stat": stat,
          "stat_equals_plain_evaluate": same,
          "stat_identical": stat == plain,
          "launches": launches["test_phase"],
          "launches_per_batch": launches["test_phase"]["in_modulate"]
          / test_batches,
          "run_wall_s": wall, "evaluate_s": dump_s,
          "s_per_batch": dump_s / test_batches,
          "eval_alone_s_per_batch": plain_s / test_batches,
          "recorder_s_per_batch": rec.seconds / test_batches,
          # the dump's permutes and copies to the host: the loop with the
          # dump less the loop without it and the recorder's own time
          "dump_copy_s_per_batch": (dump_s - plain_s - rec.seconds)
          / test_batches,
          "host_bytes_per_batch": rec.nbytes() / test_batches,
          "peak_mem_gb": peak})
    check_dump(rec, cfg, test_rows, test_rows, "test_phase")
    check(same, f"the test phase's stat {stat} differs from a plain "
                f"evaluate's {plain}")
    check(launches["test_phase"] == {"in_modulate": per_batch * test_batches,
                                     "in_modulate_bwd": 0, "bn_stats": 0,
                                     "bn_norm": 0},
          f"launches in the test phase {launches['test_phase']}")

    # test_bank: --set train into an in-memory bank (s_list, z_list)
    n_train = RUN_SUBJECTS[0] * n_slices // B * B      # drop_last
    stat_b, bank_rec, wall_b = test_run(
        "test_bank", "train", writer=Recorder(keep=("s_list", "z_list")))
    bank = (bank_rec.array("s_list"), bank_rec.array("z_list"))
    emit({"phase": "test_bank", "card": card, "set": "train",
          "rows": n_train, "keys": bank_rec.summary(),
          "bank_host_bytes": bank[0].nbytes + bank[1].nbytes,
          "launches": launches["test_bank"], "run_wall_s": wall_b,
          "s_per_batch": eval_s[-1] / (n_train // B),
          "host_bytes_per_batch": bank_rec.nbytes() / (n_train // B)})
    check_dump(bank_rec, cfg, n_train, n_train, "test_bank")

    # test_retrieval: --info nearest_neighbour and mean_src=0 from the bank
    keys = [losses.compact_s(torch.from_numpy(np.moveaxis(bank[0][:, i], 1,
                                                          -1)))
            for i in range(M)]
    out = {}
    for info, path in (("nearest_neighbour", "test_retrieval"),
                       ("mean_src=0", "test_retrieval_mean")):
        stat_r, rec_r, wall_r = test_run(
            path, "test", eval_info=info, bank=bank,
            writer=Recorder(keep=("s_list", "z_list_find_all")))
        found = rec_r.array("z_list_find_all")             # [rows, M, z]
        check_dump(rec_r, cfg, test_rows, test_rows, path, retrieval=True)
        if info == "mean_src=0":
            want = bank[1].mean(0, dtype=np.float64).astype(np.float32)
            err = float(np.abs(found - want[None]).max())
            ok = err <= MEAN_Z_ATOL
            detail = {"mean_z_max_abs_err": err, "tolerance": MEAN_Z_ATOL}
        else:
            s_q = rec_r.array("s_list")
            exact, worst = 0, 0.0
            ok = True
            for i in range(M):
                src = abs(1 - i)
                q = losses.compact_s(torch.from_numpy(np.moveaxis(
                    s_q[:, src], 1, -1)))
                cos = losses.cosine(q[:, None], keys[src][None]).numpy()
                for r in range(test_rows):
                    hit = np.where((bank[1][:, i] == found[r, i]).all(-1))[0]
                    if not len(hit):
                        ok = False
                        continue
                    gap = float(cos[r].max() - cos[r, hit].max())
                    worst = max(worst, gap)
                    exact += int(np.argmax(cos[r]) in hit)
            ok = ok and worst <= RETRIEVAL_COS_ATOL
            detail = {"rows_of_the_bank": ok, "cpu_argmax_equal":
                      exact, "of": test_rows * M, "max_cosine_gap": worst,
                      "tolerance": RETRIEVAL_COS_ATOL}
        out[path] = stat_r
        emit(dict({"phase": path, "card": card, "info": info,
                   "keys": rec_r.summary(), "stat": stat_r,
                   "launches": launches[path],
                   "launches_per_batch": launches[path]["in_modulate"]
                   / test_batches, "run_wall_s": wall_r,
                   "s_per_batch": eval_s[-1] / test_batches,
                   "host_bytes_per_batch": rec_r.nbytes() / test_batches},
                  **detail))
        check(ok, f"{path}: retrieved z {detail}")
        check(launches[path]["in_modulate"] == 2 * per_batch * test_batches,
              f"launches in {path} {launches[path]}")

    # test_dropoff: every drop of at most two contrasts over the fold's
    # first two rows (the reference's rows 438, 450 exceed it)
    drop_rows = DROP_ROWS
    drop_batches = -(-drop_rows // B)
    stat_d, rec_d, wall_d = test_run("test_dropoff", "test_dropoff",
                                     writer=Recorder(keep=("mask",)))
    masks = rec_d.array("mask")
    drops = [[]] + [d for i in range(M)
                    for d in ([i], *[[i, j] for j in range(i + 1, M)])]
    want_mask = np.ones((drop_rows, M), np.float32)
    for r in range(drop_rows):
        want_mask[r, drops[r % DROP_TYPES_M4]] = 0.0
    emit({"phase": "test_dropoff", "card": card, "rows": drop_rows,
          "keys": rec_d.summary(), "stat": stat_d,
          "launches": launches["test_dropoff"],
          "launches_per_batch": launches["test_dropoff"]["in_modulate"]
          / drop_batches, "run_wall_s": wall_d,
          "s_per_batch": eval_s[-1] / drop_batches,
          "host_bytes_per_batch": rec_d.nbytes() / drop_batches})
    check_dump(rec_d, cfg, drop_rows, B * drop_batches, "test_dropoff",
               slice_dtype="int64")
    check(np.array_equal(masks, want_mask), "test_dropoff masks")
    check(launches["test_dropoff"]["in_modulate"] == per_batch
          * drop_batches, f"launches in test_dropoff "
                          f"{launches['test_dropoff']}")

    # serve_cli, serve_cli_zbank, serve_cli_zbank_mean: serve() over the
    # test fold, T1 missing, the source T1c; plain, then with the bank in
    # the CLI's default mode (nearest_neighbour) and in mean mode.  The
    # nearest-neighbour queries and what they retrieved are recorded.
    out_dir = tempfile.mkdtemp(prefix="rdt_serve_", dir=root)
    vols, queries = {}, []
    nearest = losses.nearest_neighbour_z_by_s

    def recording_nearest(key, z, q):
        found = nearest(key, z, q)
        queries.append((q.float().cpu().numpy(),
                        found.float().cpu().numpy()))
        return found

    for path, z_mode in (("serve_cli", None),
                         ("serve_cli_zbank", "nearest_neighbour"),
                         ("serve_cli_zbank_mean", "mean")):
        kw = {} if z_mode is None else dict(bank=bank, z_mode=z_mode)
        kernels.reset_launch_counts()
        losses.nearest_neighbour_z_by_s = recording_nearest
        t0 = time.perf_counter()
        try:
            written = serve.serve(rcfg, ["T1"], None,
                                  os.path.join(out_dir, path), fmt="npy",
                                  device=DEVICE, store=store, **kw)
            torch.cuda.synchronize()
        finally:
            losses.nearest_neighbour_z_by_s = nearest
        wall_s = time.perf_counter() - t0
        launches[path] = kernels.launch_counts()
        vols[path] = {os.path.basename(p): np.load(p)
                      for ps in written.values() for p in ps}
        steps = n_test * -(-n_slices // B)
        emit({"phase": path, "card": card, "missing": ["T1"],
              "z_mode": z_mode,
              "volumes": {k: [list(v.shape), float(v.mean()),
                              float(v.std())]
                          for k, v in vols[path].items()},
              "launches": launches[path], "wall_s": wall_s,
              "slices_per_s_with_io": test_rows / wall_s})
        check(len(vols[path]) == 3 * n_test and all(
            v.shape == (n_slices, cfg.input_height, cfg.input_width)
            and np.isfinite(v).all() for v in vols[path].values()),
            f"{path}: volumes {[v.shape for v in vols[path].values()]}")
        check(launches[path]["in_modulate"] == 6 * steps,
              f"launches in {path} {launches[path]}")
    # each z that serve_cli_zbank retrieved for the missing T1 is a bank
    # row whose cosine with the card's query is the CPU maximum's, against
    # keys of the source T1c computed on the CPU
    steps = n_test * -(-n_slices // B)
    hits, exact, worst = 0, 0, 0.0
    for q, found in queries:
        cos = losses.cosine(torch.from_numpy(q)[:, None],
                            keys[1][None]).numpy()
        for r in range(len(q)):
            hit = np.where((bank[1][:, 0] == found[r]).all(-1))[0]
            if len(hit):
                hits += 1
                worst = max(worst, float(cos[r].max() - cos[r, hit].max()))
                exact += int(np.argmax(cos[r]) in hit)
    nn_detail = {"queries": len(queries), "rows": steps * B,
                 "bank_rows_found": hits, "cpu_argmax_equal": exact,
                 "max_cosine_gap": worst,
                 "tolerance": RETRIEVAL_COS_ATOL}
    emit({"phase": "serve_cli_zbank_retrieval", **nn_detail})
    check(len(queries) == steps and hits == steps * B
          and worst <= RETRIEVAL_COS_ATOL,
          f"serve_cli_zbank: retrieved z {nn_detail}")
    # the CLI's first batch against a direct call of the serve step
    ds = DataAll("BraTS", rcfg.data_path, fold=rcfg.fold,
                 contrast_list=rcfg.contrast_list,
                 image_size=rcfg.input_size, store=store).test_dataset
    subj, rows = next(iter(serve._group_by_subject(ds.subj_list,
                                                   ds.idx_list).items()))
    got = ds.get_batch(rows[:B])
    x, m = got["inputs"], got["mask"]
    x[0] = 0.0
    m[:, 0] = 0.0
    x_hat, y = serve.make_serve_step(model, rcfg, source=1)(
        x, m, (x[1, :, :, :, 0] == 0).astype(np.float32))
    direct = {f"{subj}_T1_synth.npy": x_hat[0, :, :, :, 3],
              f"{subj}_T1c_recon.npy": x_hat[1, :, :, :, 3],
              f"{subj}_y.npy": y[..., 0]}
    gaps = {k: rel_l2(vols["serve_cli"][k][:B], v.cpu().numpy())
            for k, v in direct.items()}
    recon = f"{subj}_T1c_recon.npy"
    synth = f"{subj}_T1_synth.npy"
    zgap = {p: {"recon": rel_l2(vols[p][recon], vols["serve_cli"][recon]),
                "synth": rel_l2(vols[p][synth], vols["serve_cli"][synth])}
            for p in ("serve_cli_zbank", "serve_cli_zbank_mean")}
    emit({"phase": "serve_cli_check", "first_batch_rel_l2": gaps,
          "tolerance": SERVE_CLI_REL_L2, "zbank_vs_plain_rel_l2": zgap})
    check(max(gaps.values()) <= SERVE_CLI_REL_L2,
          f"serve CLI against a direct serve step: {gaps}")
    # the present source keeps its encoder z under retrieval
    check(all(g["recon"] <= SERVE_CLI_REL_L2 for g in zgap.values()),
          f"serve with the z bank against plain: {zgap}")
    del model, loaders
    return launches


def test_phase_zerodose(torch, kernels, card: str, cfg, ckpt_root: str,
                        run_dir: str, store) -> dict:
    """Phase ``test_phase_zerodose``: the test phase on the ZeroDose run's
    directory, the y decoded and dumped at every batch.  Returns its
    launches."""
    import os
    from representation_disentanglement_torch import main_missing
    tcfg = copy_cfg(cfg, phase="test",
                    ckpt_timelabel=os.path.basename(run_dir))
    rows = RUN_SUBJECTS[2] * (RUN_SLICES[1] - RUN_SLICES[0])
    batches = -(-rows // cfg.batch_size)
    rec = Recorder()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stat = main_missing.run(tcfg, ckpt_root=ckpt_root, store=store,
                            device=DEVICE, eval_set="test", writer=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    emit({"phase": "test_phase_zerodose", "card": card,
          "config": "configs/zerodose_pet.yaml (config.zerodose)",
          "batch": cfg.batch_size, "batches": batches,
          "keys": rec.summary(), "stat": stat, "launches": launches,
          "run_wall_s": wall, "host_bytes_per_batch": rec.nbytes() / batches})
    check_dump(rec, cfg, rows, rows, "test_phase_zerodose")
    check(all(np.isfinite(stat.get(k, np.nan)) for k in ("ssim", "psnr",
                                                         "rmse",
                                                         "recon_y_fused")),
          f"ZeroDose test-phase stat {stat}")
    check(launches["in_modulate"] == (3 + 3 * cfg.modality_num) * batches,
          f"launches in the ZeroDose test phase {launches}")
    return launches


def copy_cfg(cfg, **kw):
    import copy
    out = copy.deepcopy(cfg)
    for k, v in kw.items():
        setattr(out, k, v)
    return out


def stacked_batch(rng, cfg, targets: str):
    """[A, ...] microbatches of phantoms (``train_batch``) with targets:
    'seg' labels 0-3 from thresholds of contrast 1, or a 'pet'-like map."""
    n_micro = cfg.effective_batch // cfg.batch_size
    mbs = [train_batch(rng, cfg) for _ in range(n_micro)]
    out = {k: np.concatenate([mb[k] for mb in mbs]) for k in mbs[0]}
    ref = out["inputs"][:, 1, :, :, :, 0]                  # [A, B, H, W]
    if targets == "seg":
        lab = np.digitize(ref, [0.5, 1.0, 1.5]).astype(np.float32)
        lab[ref == 0] = 0.0
    else:
        lab = np.clip(ref, 0.0, None).astype(np.float32)
    out["targets"] = lab[..., None]
    return out


def make_step(train_mod, model, cfg):
    from representation_disentanglement_torch.training.optim import (
        make_d_optimizer, make_optimizer)
    opt = make_optimizer(model.parameters(), cfg)
    dopt = make_d_optimizer(model.parameters(), cfg) \
        if cfg.is_discrim_s else None
    return train_mod.make_train_step(model, cfg, opt, dopt)


def config_timing(torch, train_mod, card: str, phase: str, cfg, batch,
                  seed: int) -> dict:
    """Step ms, slices/s and peak memory of ``cfg``'s train step on
    ``batch`` (CUDA events over TRAIN_TIMED_STEPS steps after one)."""
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    model = build_model(cfg, device=DEVICE,
                        generator=torch.Generator().manual_seed(seed))
    step = make_step(train_mod, model, cfg)
    n_micro = cfg.effective_batch // cfg.batch_size
    pairs = train_mod.draw_pairs(np.random.default_rng(seed),
                                 cfg.modality_num, n_micro)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: step(batch, gen, pairs, pairs),
                 iters=TRAIN_TIMED_STEPS, warmup=1)
    rec = {"phase": phase, "card": card, "batch": cfg.batch_size,
           "microbatches": n_micro, "effective_batch": cfg.effective_batch,
           "step_ms": ms, "slices_per_s": cfg.effective_batch / ms * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "timed_steps": TRAIN_TIMED_STEPS}
    emit(rec)
    del model, step
    return rec


def seg_stage2_phase(torch, kernels, card: str, seed: int, store,
                     stage1_dir: str, data_path: str) -> dict:
    """Phase ``train_seg_stage2``: ``main_missing.run(config.seg_stage2)``
    resumed from a copy of the stage-1 run directory ``stage1_dir`` (its
    ``model_best.ckpt`` and ``config.yaml``), one epoch over the same
    phantoms and their ``seg`` labels.  Returns its kernel launches."""
    import csv
    import os
    import shutil
    from representation_disentanglement_torch import config, main_missing
    from representation_disentanglement_torch.training import checkpoint
    from representation_disentanglement_torch.training.train import (
        is_stage1_param)
    label = os.path.basename(stage1_dir)
    root = os.path.join(data_path, "stage2")
    d = os.path.join(root, "BraTS", "MultimodalModel", label)
    os.makedirs(d)
    for name in ("model_best.ckpt", "config.yaml"):
        shutil.copyfile(os.path.join(stage1_dir, name),
                        os.path.join(d, name))
    stage1 = checkpoint.load_checkpoint(d, "model_best.ckpt")
    cfg = config.seg_stage2(label)
    cfg.seed, cfg.data_path = seed, data_path
    cfg.epochs = int(stage1["epoch"]) + 2
    n_train, n_val, _ = RUN_SUBJECTS
    n_slices = RUN_SLICES[1] - RUN_SLICES[0]
    steps = n_train * n_slices // cfg.effective_batch
    val_batches = -(-n_val * n_slices // cfg.batch_size)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = main_missing.run(cfg, ckpt_root=root, store=store, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    epoch = cfg.epochs - 1
    after = checkpoint.load_checkpoint(d, f"epoch{epoch:03d}.ckpt")
    frozen = [k for k in after["params"] if is_stage1_param(k)
              and "running" not in k]
    changed = [k for k in frozen if not torch.equal(after["params"][k],
                                                    stage1["params"][k])]
    moved = [k for k in after["params"] if k.startswith("output_decoder.")
             and "running" not in k and k in stage1["params"]
             and not torch.equal(after["params"][k], stage1["params"][k])]
    rows = read_stat_csv(os.path.join(d, "stat.csv"))
    rec = out["epochs"][0] if out["epochs"] else {}
    train_row = rec.get("train", {})
    emit({"phase": "train_seg_stage2", "card": card, "cuts": STAGE2_CUTS,
          "config": "configs/brats_seg_stage2.yaml (config.seg_stage2)",
          "restored": out["restored"],
          "optimizer_loaded": out["optimizer_loaded"],
          "start_epoch": out["start_epoch"], "epochs": cfg.epochs,
          "wall_s": wall, "train": train_row, "val": rec.get("val"),
          "train_s": rec.get("train_s"),
          "slices_per_s": rec.get("slices_per_s"),
          "stage1_params": len(frozen), "stage1_changed": changed[:5],
          "output_decoder_moved": len(moved),
          "stat_rows": [info for info, _ in rows], "launches": launches,
          "launches_per_step_expected": {"in_modulate": 30,
                                         "in_modulate_bwd": 0}})
    n_res, n_tot = out["restored"]
    check(0 < n_res < n_tot, f"restored {n_res} of {n_tot}: the output "
                             "layer should not have been restored")
    check(not out["optimizer_loaded"], "the stage-1 optimizer was loaded")
    check([r["epoch"] for r in out["epochs"]] == [epoch]
          and rec.get("steps") == steps, f"stage-2 epochs {out['epochs']}")
    check(frozen and not changed,
          f"stage-1 parameters changed in stage 2: {changed[:5]}")
    check(bool(moved), "the output decoder did not move")
    check(all(np.isfinite(train_row.get(k, np.nan)) and train_row[k] > 0
              for k in ("recon_y", "recon_y_fused")),
          f"stage-2 y losses {train_row}")
    # the val row goes under stage 1's header, as the reference appends
    # it: its fields are the sorted keys of the epoch's val stat
    val = rec.get("val") or {}
    with open(os.path.join(d, "stat.csv"), newline="") as f:
        last = list(csv.reader(f))[-1]
    check(all(np.isfinite(val.get(k, np.nan)) for k in ("dice", "iou")),
          f"stage-2 validation without finite Dice and IoU: {val}")
    check(last[1] == "val" and np.allclose(
        [float(x) for x in last[2:]], [val[k] for k in sorted(val)]),
        f"stage-2 stat.csv val row {last}")
    want = {"in_modulate": 30 * steps + 15 * val_batches,
            "in_modulate_bwd": 0, "bn_stats": 0, "bn_norm": 0}
    check(launches == want, f"launches in stage 2 {launches}; expected "
                            f"{want}")
    return launches


def zerodose_phase(torch, kernels, card: str, seed: int) -> dict:
    """Phases ``train_zerodose`` and ``test_phase_zerodose``:
    ``main_missing.run(config.zerodose())`` for two epochs on ZeroDose
    phantoms (T1, T2-FLAIR, the PET target; dropoff on) held in memory,
    then its test phase.  Returns the kernel launches of both."""
    import os
    import shutil
    import tempfile
    from representation_disentanglement_torch import config, main_missing
    from representation_disentanglement_torch.data import synthetic
    from representation_disentanglement_torch.data.dataset import (
        VolumeStore, fold_txt_names)
    cfg = config.zerodose()
    tmp = tempfile.mkdtemp(prefix="rdt_zerodose_")
    try:
        cfg.seed, cfg.data_path = seed, tmp
        cfg.epochs, cfg.epoch_chunk_steps = RUN_EPOCHS, RUN_CHUNK
        t0 = time.perf_counter()
        vols, subjects, _ = synthetic.synthetic_volumes(
            "ZeroDose", cfg.contrast_list, "z-score", sum(RUN_SUBJECTS),
            (cfg.input_height, cfg.input_width, RUN_DEPTH), seed)
        n_train, n_val, _ = RUN_SUBJECTS
        synthetic.write_fold_txts(
            tmp, fold_txt_names("ZeroDose", cfg.fold, cfg.modality_num),
            (subjects[:n_train], subjects[n_train:n_train + n_val],
             subjects[n_train + n_val:]), RUN_SLICES)
        data_s = time.perf_counter() - t0
        n_slices = RUN_SLICES[1] - RUN_SLICES[0]
        steps = n_train * n_slices // cfg.effective_batch
        val_batches = -(-n_val * n_slices // cfg.batch_size)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        store = VolumeStore(data=vols)
        out = main_missing.run(cfg, ckpt_root=os.path.join(tmp, "ckpt"),
                               store=store, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        rows = read_stat_csv(os.path.join(out["ckpt_path"], "stat.csv"))
        epochs = out["epochs"]
        emit({"phase": "train_zerodose", "card": card, "cuts": ZD_CUTS,
              "config": "configs/zerodose_pet.yaml (config.zerodose)",
              "data_s": data_s, "loader": out["loader"], "wall_s": wall,
              "epochs": [{"epoch": r["epoch"], "steps": r["steps"],
                          "train_s": r["train_s"],
                          "slices_per_s": r["slices_per_s"],
                          "val_s": r["val_s"], "train": r["train"],
                          "val": r["val"], "monitor": r["monitor"]}
                         for r in epochs],
              "stat_rows": [info for info, _ in rows], "launches": launches,
              "launches_per_step_expected": {"in_modulate": 18,
                                             "in_modulate_bwd": 18}})
        check(out["loader"] == "device" and [r["steps"] for r in epochs]
              == [steps] * RUN_EPOCHS, f"ZeroDose epochs {epochs}")
        for r in epochs:
            check(all(np.isfinite(r["train"][k]) and r["train"][k] > 0
                      for k in ("recon_y", "recon_y_fused", "recon_x",
                                "recon_x_mix")),
                  f"ZeroDose train losses {r['train']}")
            check(all(np.isfinite(r["val"].get(k, np.nan))
                      for k in ("ssim", "psnr", "rmse")),
                  f"ZeroDose val metrics on the fused y {r['val']}")
            check(r["monitor"] == r["val"]["recon_y_fused"],
                  "the ZeroDose monitor is not recon_y_fused")
        want = {"in_modulate": 18 * steps * RUN_EPOCHS
                + 9 * val_batches * RUN_EPOCHS,
                "in_modulate_bwd": 18 * steps * RUN_EPOCHS,
                "bn_stats": 0, "bn_norm": 0}
        check(launches == want, f"launches in the ZeroDose run {launches}; "
                                f"expected {want}")
        return launches, test_phase_zerodose(
            torch, kernels, card, cfg, os.path.join(tmp, "ckpt"),
            out["ckpt_path"], store)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def adv_kl_phase(torch, kernels, fused_bn, train_mod, card: str, seed: int,
                 batch, pairs) -> dict:
    """Phase ``train_adv_kl``: ADV_STEPS flagship steps with the s
    discriminator and the KL (ADV_LOSSES), with the z prior off and on,
    then with ``fuse_bn``; and K6/K7 against their plain versions at the
    discriminator's BatchNorm shapes.  Returns the launches of each run."""
    from representation_disentanglement_torch import config
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    out = {}
    for variant in ("prior_off", "prior_on", "fused_bn"):
        cfg = config.flagship()
        for k, v in ADV_LOSSES.items():
            setattr(cfg, k, v)
        cfg.is_distri_z = variant == "prior_on"
        cfg.fuse_bn = variant == "fused_bn"
        cfg.derive().validate()
        model = build_model(cfg, device=DEVICE,
                            generator=torch.Generator().manual_seed(seed))
        watch = ["discrim_s.fc.3.weight", "discrim_s.discrim.0.weight"] + (
            ["distri_z.linear.2.weight"] if cfg.is_distri_z else [])
        before = {k: v.detach().clone()
                  for k, v in model.named_parameters() if k in watch}
        step = make_step(train_mod, model, cfg)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        history, per_step, carry = [], [], None
        kernels.reset_launch_counts()
        for i in range(ADV_STEPS):
            c0 = kernels.launch_counts()
            history.append(train_mod.metrics_to_dict(
                step(batch, gen, pairs, pairs, first_of_epoch=(i == 0))))
            c1 = kernels.launch_counts()
            per_step.append({k: c1[k] - c0[k] for k in c1})
            if i == 0:
                carry = float(torch.sqrt(sum(
                    p.grad.float().square().sum()
                    for n, p in model.named_parameters()
                    if n.startswith("anatomy_encoder"))))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        moved = {k: not torch.equal(v, dict(model.named_parameters())[k])
                 for k, v in before.items()}
        emit({"phase": "train_adv_kl", "variant": variant, "card": card,
              "steps": ADV_STEPS, "batch": cfg.batch_size,
              "losses": ADV_LOSSES, "is_distri_z": cfg.is_distri_z,
              "fuse_bn": cfg.fuse_bn, "metrics": history,
              "carry_norm_after_step_0": carry, "moved": moved,
              "launches_per_step": per_step, "launches": launches})
        for h in history:
            check(all(np.isfinite(v) for v in h.values()),
                  f"non-finite adversarial metrics: {h}")
            check(all(h[k] != 0.0 for k in ("adv_s", "adv_s_d", "kl")),
                  f"an adversarial or KL term is zero: {h}")
        check(all(moved.values()), f"parameters that did not move: {moved}")
        check(carry is not None and carry > 0.0,
              "no discriminator gradient was carried after step 0")
        for i, counts in enumerate(per_step):
            bn = 0
            if cfg.fuse_bn:
                bn = (BN_CALLS_FIRST if i == 0 else BN_CALLS) + len(
                    D_BN_SHAPES)
            want = {"in_modulate": 15, "in_modulate_bwd": 15,
                    "bn_stats": bn, "bn_norm": bn}
            check(counts == want, f"launches in adversarial step {i} "
                                  f"({variant}): {counts}; expected {want}")
        out[variant] = launches
        del model, step

    # K6/K7 against plain at the discriminator's BatchNorm shapes
    worst = {"stats_abs": 0.0, "y_abs": 0.0}
    for k, shape in enumerate(D_BN_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            x, scale, bias = bn_case(torch, shape, dtype, seed + 100 + k)
            res = bn_errors(torch, fused_bn, x, scale, bias,
                            bn_norm_from_plain_stats(fused_bn, x, scale,
                                                     bias))
            worst["stats_abs"] = max(worst["stats_abs"],
                                     res["stats_max_abs_err"])
            worst["y_abs"] = max(worst["y_abs"], res["y_max_abs_err"])
            emit(dict({"phase": "bn_kernel_check", "site": "discrim_s",
                       "shape": list(shape), "dtype": str(dtype)[6:]},
                      **res))
            check(res["ok"], f"BatchNorm kernels disagree with plain at "
                             f"the discriminator's {shape} {dtype}")
    out["d_bn_err"] = worst
    return out


def step_ms(torch, fn, n: int, warmup: int = 1) -> list:
    """CUDA-event times of ``n`` calls of ``fn``, one by one, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def volume_targets(t1: np.ndarray) -> np.ndarray:
    """Labels 1-3 for a phantom (no BraTS phantom subject carries more than
    one label): the T1 intensity inside the brain (above the background's
    -10) binned at its 70th, 85th and 95th percentiles."""
    brain = t1 > -10
    cuts = np.quantile(t1[brain], [0.7, 0.85, 0.95])
    return (np.digitize(t1, cuts) * brain).astype(np.float32)


def volume_batch(store, subjects, contrasts):
    """[B, M, H, W, D] inputs of ``subjects`` at main_3d's default slab and
    [B, 1, H, W, D] targets with labels 1-3 (``volume_targets``)."""
    from representation_disentanglement_torch.data.dataset3d import (
        VolumeDataset3D, collate_volumes)
    ds = VolumeDataset3D("BraTS", store, subjects, contrasts,
                         image_size=VOL_HWD)
    b = collate_volumes([ds[i] for i in range(len(subjects))])
    b["targets"] = np.stack([volume_targets(x[0]) for x in b["inputs"]])[
        :, None]
    return b


def grad_gaps(named_a, named_b, width: int) -> dict:
    """Per parameter the relative L2 gap of the two sides' gradients; for
    the GroupNorm-cancelled biases (``conv1.bias`` of width ``width``) the
    largest gap over the largest gradient entry of the model."""
    largest = max(float(p.grad.abs().max()) for p in named_b.values())
    out = {}
    for name, pb in named_b.items():
        ga, gb = named_a[name].grad.cpu().double(), pb.grad.cpu().double()
        if name.endswith("conv1.bias") and pb.shape[0] == width:
            out[name] = float((ga - gb).abs().max()) / largest
        else:
            out[name] = float((ga - gb).norm() / gb.norm())
    return out


def volume3d_phases(torch, kernels, card: str, seed: int, store,
                    f32_peak: float) -> dict:
    """Phases ``train3d``, ``train3d_card_vs_cpu``, ``train3d_accum``,
    ``eval3d_timing`` and ``main3d_run``/``_resume``/``_preempt``/``_test``:
    the whole-volume 3D path (NVNet3D, ``training/train3d.py``,
    ``main_3d.run``) at main_3d's defaults on ``store``'s phantoms (those
    of ``train_run``).  No hand-written kernel lies on this path: each
    phase's launches are read and must be 0.  Returns the launches of each
    path."""
    import copy
    import shutil
    import tempfile
    from representation_disentanglement_torch.models.unet3d import (
        build_nvnet3d)
    from representation_disentanglement_torch.training import train3d

    contrasts = ["T1", "T1c", "T2", "T2_FLAIR"]
    subjects = sorted({k.split("/")[0] for k in store.keys()})
    paths = {}

    def no_launches(path: str, launches: dict) -> None:
        paths[path] = launches
        check(not any(launches.values()),
              f"a kernel was launched on the 3D path {path}: {launches}")

    # train3d: five Adam steps at full width on one fixed batch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_nvnet3d(VOL_HWD, len(contrasts), 3, VOL_INIT,
                          device=DEVICE,
                          generator=torch.Generator().manual_seed(seed))
    opt = train3d.create_state_3d(model, lr=VOL_LR)
    step = train3d.make_train_step_3d(model, opt)
    b = volume_batch(store, subjects[:1], contrasts)
    batch = {k: torch.as_tensor(b[k], device=DEVICE)
             for k in ("inputs", "targets")}
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    kernels.reset_launch_counts()
    metrics = []
    for _ in range(VOL_STEPS):
        m = step(batch, gen)
        metrics.append({k: float(v) for k, v in zip(
            train3d.METRIC_KEYS, torch.stack(
                [m[k] for k in train3d.METRIC_KEYS]).cpu().numpy())})
    no_launches("train3d", kernels.launch_counts())
    zero = [n for n, p in model.named_parameters()
            if p.grad is None or not bool(p.grad.abs().max() > 0)]
    times = step_ms(torch, lambda: step(batch, gen), VOL_TIMED_STEPS)
    ms = float(np.median(times))
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = step_ms(torch, lambda: step(batch, gen), VOL_TIMED_STEPS)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    losses = [r["loss"] for r in metrics]
    emit({"phase": "train3d", "card": card, "hwd": list(VOL_HWD),
          "contrasts": contrasts, "init_channels": VOL_INIT, "batch": 1,
          "dtype": "f32", "params": sum(p.numel()
                                        for p in model.parameters()),
          "labels": np.unique(b["targets"]).tolist(), "build_s": build_s,
          "metrics": metrics, "step_ms": ms, "step_ms_all": times,
          "volumes_per_s": 1e3 / ms,
          "flop_per_step": VOL_TRAIN_FLOP,
          "f32_peak_share": VOL_TRAIN_FLOP / (ms / 1e3) / f32_peak,
          "peak_mem_gb": peak, "allocated_before_gb": before / 1e9,
          "step_ms_tf32_cudnn": float(np.median(tf32)),
          "step_ms_tf32_cudnn_all": tf32,
          "launches": paths["train3d"]})
    check(all(np.isfinite(v) for r in metrics for v in r.values()),
          f"non-finite 3D train metrics: {metrics}")
    check(losses[-1] < losses[0], f"the 3D loss did not fall over "
                                  f"{VOL_STEPS} steps: {losses}")
    check(not zero, f"parameters without a gradient: {zero}")

    # train3d_card_vs_cpu: one deterministic f32 step at a small size from
    # the same weights, on the card and on the CPU (cuDNN's 3D algorithms)
    hwd, m_small = VOL_SMALL_HWD, VOL_SMALL_M
    cpu = build_nvnet3d(hwd, m_small, 3, VOL_SMALL_INIT, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    card_m = copy.deepcopy(cpu).to(DEVICE)
    rs = np.random.default_rng(seed)
    xs = rs.normal(size=(1, m_small) + hwd).astype(np.float32)
    ts = rs.integers(0, 4, size=(1, 1) + hwd).astype(np.float32)
    out = {}
    for name, mod in (("cpu", cpu), ("card", card_m)):
        dev = mod.device
        out[name] = train3d.make_train_step_3d(
            mod, train3d.create_state_3d(mod, lr=VOL_LR))(
            {"inputs": torch.as_tensor(xs, device=dev),
             "targets": torch.as_tensor(ts, device=dev)})
    loss_rel = {k: abs(float(out["card"][k]) - float(out["cpu"][k]))
                / abs(float(out["cpu"][k])) for k in train3d.METRIC_KEYS}
    gaps = grad_gaps(dict(card_m.named_parameters()),
                     dict(cpu.named_parameters()), VOL_SMALL_INIT)
    worst = max(gaps, key=gaps.get)
    emit({"phase": "train3d_card_vs_cpu", "hwd": list(hwd),
          "init_channels": VOL_SMALL_INIT, "contrasts": m_small,
          "metric_rel": loss_rel, "grad_rel_l2_max": gaps[worst],
          "grad_rel_l2_worst": worst,
          "grad_rel_l2_median": float(np.median(list(gaps.values()))),
          "tolerance": {"metric_rel": VOL_CARD_CPU_LOSS_REL,
                        "kl_rel": VOL_CARD_CPU_KL_REL,
                        "grad_rel_l2": VOL_CARD_CPU_GRAD_REL_L2}})
    check(max(v for k, v in loss_rel.items() if k != "kl")
          <= VOL_CARD_CPU_LOSS_REL and loss_rel["kl"] <= VOL_CARD_CPU_KL_REL
          and gaps[worst] <= VOL_CARD_CPU_GRAD_REL_L2,
          "the 3D step on the card and on the CPU disagree")
    del cpu, card_m

    # train3d_accum: one accum=2 step at full width (two subjects)
    b2 = volume_batch(store, subjects[1:3], contrasts)
    stacked = {k: torch.as_tensor(b2[k][:, None], device=DEVICE)
               for k in ("inputs", "targets")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    acc = train3d.make_train_step_3d(model, opt, accum=2)(stacked, gen)
    acc = {k: float(v) for k, v in acc.items()}
    torch.cuda.synchronize()
    no_launches("train3d_accum", kernels.launch_counts())
    peak_acc = (torch.cuda.max_memory_allocated() - before) / 1e9
    emit({"phase": "train3d_accum", "card": card, "accum": 2,
          "metrics": acc, "peak_mem_gb": peak_acc,
          "train3d_peak_mem_gb": peak,
          "launches": paths["train3d_accum"]})
    check(all(np.isfinite(v) for v in acc.values()),
          f"non-finite accum=2 metrics: {acc}")
    del stacked

    # eval3d_timing: the eval step at full width
    eval_step = train3d.make_eval_step_3d(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    etimes = step_ms(torch, lambda: eval_step(batch["inputs"]),
                     VOL_TIMED_STEPS)
    no_launches("eval3d", kernels.launch_counts())
    ems = float(np.median(etimes))
    probs, _ = eval_step(batch["inputs"])
    emit({"phase": "eval3d_timing", "card": card, "step_ms": ems,
          "step_ms_all": etimes, "volumes_per_s": 1e3 / ems,
          "f32_peak_share": VOL_FWD_FLOP / (ems / 1e3) / f32_peak,
          "peak_mem_gb": (torch.cuda.max_memory_allocated() - before)
          / 1e9, "launches": paths["eval3d"]})
    check(float(probs.min()) >= 0 and float(probs.max()) <= 1
          and bool(torch.isfinite(probs).all()),
          "eval probabilities outside [0, 1]")
    del model, opt, step, batch, probs, eval_step

    tmp = tempfile.mkdtemp(prefix="rdt_main3d_")
    try:
        main3d_phases(torch, kernels, card, store, subjects, contrasts, tmp,
                      before, no_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


def main3d_phases(torch, kernels, card, store, subjects, contrasts, tmp,
                  before, no_launches) -> None:
    """``main3d_run``, ``main3d_resume``, ``main3d_preempt`` and
    ``main3d_test``: ``main_3d.run`` on VOL_RUN_SUBJECTS of the phantoms
    in memory with ``_noval`` fold txts under ``tmp``; ``no_launches``
    records and checks each path's launches."""
    import os
    from representation_disentanglement_torch import main_3d
    from representation_disentanglement_torch.data import synthetic
    from representation_disentanglement_torch.training import checkpoint
    from representation_disentanglement_torch.utils import preempt

    n_train, n_val, n_test = VOL_RUN_SUBJECTS
    picked = subjects[:n_train + n_val + n_test]
    synthetic.write_fold_txts(
        tmp, [f"fold_BraTS_0_{s}_noval.txt" for s in ("train", "val",
                                                     "test")],
        (picked[:n_train], picked[n_train:n_train + n_val],
         picked[n_train + n_val:]), (62, 63))
    ckpt = os.path.join(tmp, "ckpt3d")

    def run(*extra, guard=None):
        args = main_3d.build_parser().parse_args(
            ["--data-path", tmp, "--ckpt-dir", ckpt, "--image-size",
             *map(str, VOL_HWD), "--init-channels", str(VOL_INIT),
             "--contrasts", *contrasts, *extra])
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = main_3d.run(args, device=DEVICE, store=store, guard=guard)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, kernels.launch_counts()

    adam_step = lambda c: {float(s["step"])
                           for s in c["opt_state"]["state"].values()}
    torch.cuda.reset_peak_memory_stats()
    out, wall, launches = run("--epochs", str(VOL_RUN_EPOCHS))
    no_launches("main3d_run", launches)
    rows = read_stat_csv(os.path.join(ckpt, "stat.csv"))
    loaded = {name: checkpoint.load_checkpoint(ckpt, name)
              for name in ("epoch000.ckpt", "epoch001.ckpt",
                           "model_best.ckpt")}
    emit({"phase": "main3d_run", "card": card, "cuts": VOL_RUN_CUTS,
          "wall_s": wall, "epochs": [
              {k: r[k] for k in ("epoch", "steps", "train_s",
                                 "volumes_per_s", "val_s", "val_dice",
                                 "ckpt_bytes", "monitor", "is_best")}
              | {"ckpt_save_ms": r["ckpt_save_s"] * 1e3,
                 "loss": r["train"]["loss"]} for r in out["epochs"]],
          "stat_rows": [info for info, _ in rows],
          "checkpoint_epochs": {n: c["epoch"] for n, c in loaded.items()},
          "run_peak_mem_gb": (torch.cuda.max_memory_allocated() - before)
          / 1e9, "launches": launches})
    check([info for info, _ in rows] == ["epoch[ 0]", "epoch[ 1]"]
          and all("val_dice" in r and np.isfinite(list(r.values())).all()
                  for _, r in rows), f"3D stat.csv rows {rows}")
    check([r["steps"] for r in out["epochs"]] == [n_train] * VOL_RUN_EPOCHS,
          f"3D steps per epoch {[r['steps'] for r in out['epochs']]}")
    check(loaded["epoch000.ckpt"]["epoch"] == 0
          and loaded["epoch001.ckpt"]["epoch"] == 1
          and loaded["model_best.ckpt"]["epoch"] in (0, 1),
          "3D checkpoint epochs")
    e1 = loaded["epoch001.ckpt"]
    del loaded

    out, wall, launches = run("--epochs", str(VOL_RUN_EPOCHS + 1),
                              "--resume")
    no_launches("main3d_resume", launches)
    e2 = checkpoint.load_checkpoint(ckpt, "epoch002.ckpt")
    same = sum(torch.equal(e1["params"][k], e2["params"][k])
               for k in e1["params"])
    emit({"phase": "main3d_resume", "resume": out["resume"],
          "start_epoch": out["start_epoch"], "wall_s": wall,
          "optimizer_step": [sorted(adam_step(e1)), sorted(adam_step(e2))],
          "epochs": [{"epoch": r["epoch"], "train_s": r["train_s"],
                      "volumes_per_s": r["volumes_per_s"]}
                     for r in out["epochs"]],
          "tensors_unchanged_by_epoch_2": same, "launches": launches})
    n_tot = len(e1["params"])
    check(out["resume"] == {"resume_name": "epoch001.ckpt",
                            "restored": [n_tot, n_tot],
                            "optimizer_loaded": True},
          f"the 3D resume: {out['resume']}")
    check(out["start_epoch"] == 2 and [r["epoch"] for r in out["epochs"]]
          == [2], "the resumed 3D run did not run exactly epoch 2")
    check(adam_step(e1) == {n_train * 2.0}
          and adam_step(e2) == {n_train * 3.0},
          f"Adam steps {adam_step(e1)}, {adam_step(e2)}")
    del e1, e2

    guard = preempt.PreemptionGuard()
    guard.request()
    out, wall, launches = run("--epochs", str(VOL_RUN_EPOCHS + 2),
                              "--resume", guard=guard)
    no_launches("main3d_preempt", launches)
    with open(preempt.preempt_path(ckpt) + ".epoch") as f:
        tag = f.read()
    pre = checkpoint.load_checkpoint(ckpt, preempt.PREEMPT_NAME)
    emit({"phase": "main3d_preempt", "record": out["epochs"],
          "sidecar": tag, "preempt_epoch": pre["epoch"],
          "optimizer_step": sorted(adam_step(pre)), "wall_s": wall})
    check(out["epochs"] == [{"epoch": 3, "preempted_after_steps": 1}]
          and tag == "2" and pre["epoch"] == 2
          and adam_step(pre) == {n_train * 3.0 + 1},
          f"the 3D preemption: {out['epochs']}, sidecar {tag!r}, epoch "
          f"{pre['epoch']}")
    del pre

    out, wall, launches = run("--phase", "test")
    no_launches("main3d_test", launches)
    rows = read_stat_csv(os.path.join(ckpt, "stat.csv"))
    labels, shapes = set(), []
    for path in out["files"]:
        if path.endswith(".npy"):
            lab = np.load(path)
        else:                             # NIfTI [H, W, D] when nibabel is
            import nibabel                # there
            lab = np.transpose(np.asarray(nibabel.load(path).dataobj),
                               (2, 0, 1))
        shapes.append(list(lab.shape))
        labels |= set(np.unique(lab).tolist())
    emit({"phase": "main3d_test", "card": card, "per_subject":
          out["per_subject"], "dice": out["dice"], "iou": out["iou"],
          "restored": out["restored"], "files": [os.path.basename(p) for p
                                                 in out["files"]],
          "shapes": shapes, "labels": sorted(labels), "wall_s": wall,
          "stat_rows": [info for info, _ in rows], "launches": launches})
    H, W, D = VOL_HWD
    check(len(out["per_subject"]) == n_test and all(
        0.0 <= v <= 1.0 for s in out["per_subject"].values()
        for v in s.values()), f"3D test scores {out['per_subject']}")
    check(shapes == [[D, H, W]] * n_test and labels <= {0.0, 1.0, 2.0, 3.0},
          f"3D label volumes {shapes}, labels {labels}")
    check(rows[-1][0] == "test", f"3D stat.csv's last row {rows[-1][0]}")


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
    from representation_disentanglement_torch.ops import fused_bn, kernels

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

    # 3. kernels against plain: forward at the serving shapes, forward and
    # backward at the training shapes of every configuration this script
    # trains (the flagship and its adversarial step, stage 2, ZeroDose),
    # and forward at the short last batch of test_dropoff's eval grid
    cfg = config.flagship()
    tshapes = train_shapes(cfg.modality_num, cfg.batch_size)
    max_err = check_kernels(torch, kernels, args.seed)
    max_err_bwd = 0.0
    for c in (cfg, config.seg_stage2("check"), config.zerodose()):
        shapes = train_shapes(c.modality_num, c.batch_size)
        max_err = max(max_err, check_kernels(torch, kernels, args.seed,
                                             shapes))
        max_err_bwd = max(max_err_bwd, check_bwd_kernels(
            torch, kernels, args.seed, shapes))
    tail = DROP_ROWS % cfg.batch_size
    if tail:
        max_err = max(max_err, check_kernels(
            torch, kernels, args.seed, train_shapes(cfg.modality_num,
                                                    tail)))

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
    check(launches["bn_stats"] == launches["bn_norm"] == 0,
          "a BatchNorm kernel was launched in eval mode")

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

    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "cold_ms": 0.0}
    bound_by_ops = False
    for name, dtypes, zi, gamma, beta in kernel_cases(torch, args.seed):
        if dtypes != "bf16":
            continue
        k_ms = time_ms(torch, lambda: kernels.in_modulate_cuda(
            zi, gamma, beta), iters=50)
        c_ms = cold_ms(torch, lambda: kernels.in_modulate_cuda(
            zi, gamma, beta))
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
        totals["cold_ms"] += c_ms
        emit({"phase": "kernel_timing", "kernel": "in_modulate",
              "block": name, "shape": list(zi.shape), "card": card,
              "ms": k_ms, "cold_ms": c_ms, "plain_ms": p_ms,
              "bound_ms": bound, "bytes": nbytes,
              "bound_share": bound / k_ms, "cold_bound_share": bound / c_ms})
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
                         "in_modulate_bwd": per_step_expected,
                         "bn_stats": 0, "bn_norm": 0},
              f"launches per train step {counts}; expected "
              f"{per_step_expected} of each SPADE kernel and no BatchNorm "
              "kernel")

    # 8. one step with the kernels against the plain interior
    loss_rel, _, grad_rel, leaf_med, leaf_max = compare_one_step(
        torch, T, model, cfg, batch, pairs[0], args.seed,
        model.set_use_pallas)
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
    loss_rel32, _, grad_rel32, leaf_med32, leaf_max32 = compare_one_step(
        torch, T, m32, small, b32, pairs[0], args.seed, m32.set_use_pallas)
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

    per_step = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                    "cold_ms": 0.0}
                for k in ("in_modulate", "in_modulate_bwd")}
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
            c_ms = cold_ms(torch, kfn)
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
            acc["cold_ms"] += reps * c_ms
            emit({"phase": "kernel_timing_bwd" if kname.endswith("bwd")
                  else "kernel_timing_train_fwd", "kernel": kname,
                  "block": name, "shape": list(zi.shape), "card": card,
                  "launches_per_step": reps, "ms": k_ms, "cold_ms": c_ms,
                  "plain_ms": p_ms, "bound_ms": bound, "bytes": nbytes,
                  "bound_share": bound / k_ms,
                  "cold_bound_share": bound / c_ms, "library_ms": None,
                  "library_note": "no single PyTorch call computes it"})
    del zi, gamma, g, beta

    # 10. the BatchNorm kernels against plain at every BatchNorm call of the
    # flagship train step (the call sites of one first-of-epoch forward)
    import torch.nn.functional as F
    calls = bn_calls(torch, T, model, cfg, batch, pairs[0])
    regular = [c for c in calls if not c[0].startswith("output_decoder")]
    check((len(calls), len(regular)) == (BN_CALLS_FIRST, BN_CALLS),
          f"{len(calls)} BatchNorm calls in a first-of-epoch step, "
          f"{len(regular)} in a later one; expected {BN_CALLS_FIRST} and "
          f"{BN_CALLS}")
    sites = list(dict.fromkeys(calls))          # the latent cycle repeats
    bn_err = {"mean_rel": 0.0, "var_rel": 0.0, "stats_abs": 0.0,
              "y_abs": 0.0}
    for k, (name, *shape) in enumerate(sites):
        for dtype in (torch.bfloat16, torch.float32):
            x, scale, bias = bn_case(torch, shape, dtype, args.seed + k)
            res = bn_errors(torch, fused_bn, x, scale, bias,
                            bn_norm_from_plain_stats(fused_bn, x, scale,
                                                     bias))
            bn_err["mean_rel"] = max(bn_err["mean_rel"],
                                     res["mean_err_rel_mean_abs_x"])
            bn_err["var_rel"] = max(bn_err["var_rel"],
                                    res["var_err_rel_mean_x2"])
            bn_err["stats_abs"] = max(bn_err["stats_abs"],
                                      res["stats_max_abs_err"])
            bn_err["y_abs"] = max(bn_err["y_abs"], res["y_max_abs_err"])
            emit(dict({"phase": "bn_kernel_check", "site": name,
                       "shape": shape, "dtype": str(dtype)[6:],
                       "tolerance": f"mean {BN_STATS_REL} x mean|x|, var "
                       f"{BN_STATS_REL} x mean(x^2); y 2^"
                       f"{int(np.log2(BN_NORM_REL))} x the magnitudes of "
                       f"its terms + {BF16_ULPS} bf16 ulps of a bf16 y"},
                      **res))
            check(res["ok"], f"BatchNorm kernels disagree with plain at "
                             f"{name} {shape} {dtype}")
    del x, scale, bias

    # 11. the fused-BN train path: a flagship model with fuse_bn on
    cfg_f = config.flagship()
    cfg_f.fuse_bn = True
    mf = build_model(cfg_f, device=DEVICE,
                     generator=torch.Generator().manual_seed(args.seed))
    (step_f, gen_f, hist_f, per_step_f, fused_launches, unreached_f,
     unmoved_f) = run_train(torch, kernels, T, mf, cfg_f, batch, pairs,
                            args.seed, steps=TRAIN_FUSED_STEPS)
    recon_f = [recon_loss(cfg_f, h) for h in hist_f]
    emit({"phase": "train_fused_bn", "steps": TRAIN_FUSED_STEPS,
          "batch": cfg_f.batch_size, "metrics": hist_f,
          "recon_loss": recon_f, "launches_per_step": per_step_f,
          "launches": fused_launches, "unreached_params": unreached_f,
          "unmoved_bn_stats": unmoved_f})
    for h in hist_f:
        check(all(np.isfinite(v) for v in h.values()),
              f"non-finite fused-BN train metrics: {h}")
    check(not unreached_f, f"parameters without gradient: {unreached_f[:5]}")
    check(not unmoved_f, f"BatchNorm statistics that did not move: "
                         f"{unmoved_f[:5]}")
    # over three steps the total follows the sim_s hinge (weight 10), which
    # swings from step to step; the reconstruction loss is what must fall
    check(recon_f[-1] < recon_f[0],
          f"the fused-BN reconstruction loss did not fall: {recon_f}")
    for i, counts in enumerate(per_step_f):
        bn = BN_CALLS_FIRST if i == 0 else BN_CALLS
        check(counts == {"in_modulate": per_step_expected,
                         "in_modulate_bwd": per_step_expected,
                         "bn_stats": bn, "bn_norm": bn},
              f"launches in fused-BN train step {i}: {counts}; expected "
              f"{bn} of each BatchNorm kernel")

    # 12. one step with the fused against the unfused BatchNorm
    loss_rel_f, loss_abs_f, grad_rel_f, leaf_med_f, leaf_max_f = \
        compare_one_step(torch, T, mf, cfg_f, batch, pairs[0], args.seed,
                         mf.set_fuse_bn)
    emit({"phase": "train_fused_vs_unfused", "dtype": "bf16",
          "loss_rel": loss_rel_f, "latent_z_abs": loss_abs_f["latent_z"],
          "grad_rel_l2": grad_rel_f, "grad_leaf_rel_l2_median": leaf_med_f,
          "grad_leaf_rel_l2_max": leaf_max_f,
          "tolerance": {"loss_rel": FUSED_BF16_LOSS_REL,
                        "latent_z_abs": FUSED_BF16_LATENT_ATOL,
                        "grad_rel_l2": FUSED_BF16_GRAD_REL_L2}})
    check(max(v for k, v in loss_rel_f.items() if k != "latent_z")
          <= FUSED_BF16_LOSS_REL
          and loss_abs_f["latent_z"] <= FUSED_BF16_LATENT_ATOL
          and grad_rel_f <= FUSED_BF16_GRAD_REL_L2,
          "bf16 train step: fused and unfused BatchNorm disagree")
    m32 = build_model(small, device=DEVICE,
                      generator=torch.Generator().manual_seed(args.seed))
    m32.train()
    loss_rel32f, _, grad_rel32f, leaf_med32f, leaf_max32f = compare_one_step(
        torch, T, m32, small, b32, pairs[0], args.seed, m32.set_fuse_bn)
    emit({"phase": "train_fused_vs_unfused", "dtype": "f32",
          "input_size": [64, 96], "batch": 2, "loss_rel": loss_rel32f,
          "grad_rel_l2": grad_rel32f, "grad_leaf_rel_l2_median": leaf_med32f,
          "grad_leaf_rel_l2_max": leaf_max32f,
          "tolerance": {"loss_rel": FUSED_F32_LOSS_REL,
                        "grad_rel_l2": FUSED_F32_GRAD_REL_L2}})
    check(max(loss_rel32f.values()) <= FUSED_F32_LOSS_REL
          and grad_rel32f <= FUSED_F32_GRAD_REL_L2,
          "f32 train step: fused and unfused BatchNorm disagree")
    del m32

    # 13. the validation step on the fused-trained model
    from representation_disentanglement_torch.training import evaluate as E
    vbatches = eval_batches(rng, cfg_f, EVAL_BATCHES)
    eval_steps = E.make_eval_step(mf, cfg_f)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stat = E.evaluate(mf, cfg_f, vbatches, eval_steps=eval_steps)
    eval_wall = time.perf_counter() - t0
    eval_launches = kernels.launch_counts()
    again = E.evaluate(mf, cfg_f, vbatches, eval_steps=eval_steps)
    # a contrast absent from a sample has an empty ground truth, whose PSNR
    # is -inf by the reference's rule (data_range 0)
    missing = any(float(b["mask"].min()) == 0.0 for b in vbatches)
    emit({"phase": "eval", "batches": EVAL_BATCHES,
          "batch": cfg_f.batch_size, "stat": stat, "wall_s": eval_wall,
          "launches": eval_launches, "identical_second_call": again == stat,
          "psnr_note": "-inf where a sample lacks a contrast (empty ground "
                       "truth, data_range 0)" if missing else ""})
    check(all(np.isfinite(stat[k]) for k in T.LOSS_KEYS),
          f"non-finite validation losses: {stat}")
    check(np.isfinite(stat["ssim"]) and stat["ssim"] <= 1.0
          and np.isfinite(stat["rmse"]),
          f"validation metrics out of range: {stat}")
    check(np.isfinite(stat["psnr"]) or (missing and stat["psnr"] == -np.inf),
          f"validation PSNR {stat['psnr']}")
    check(again == stat, "a second evaluate gave another stat dict")
    check(eval_launches == {"in_modulate": per_step_expected * EVAL_BATCHES,
                            "in_modulate_bwd": 0, "bn_stats": 0,
                            "bn_norm": 0},
          f"launches in validation: {eval_launches}")

    # 14-17. a whole training run, its resume, a preemption and the host
    # loader
    run_launches, host_launches, stage2_launches, test_launches, store = \
        train_run_phases(torch, kernels, args.seed, card, per_step_expected,
                         cfg.batch_size / train_ms * 1e3)

    # the remaining 2D configurations: ZeroDose, then the adversarial step
    # with the KL, the z prior off and on and with the fused BatchNorm
    zd_launches, zd_test_launches = zerodose_phase(torch, kernels, card,
                                                   args.seed)
    adv = adv_kl_phase(torch, kernels, fused_bn, T, card, args.seed, batch,
                       pairs)

    # 18. the eval step's time at B=16 with the y decodes (bench.py times
    # it so), on a batch already on the card
    eval_step = eval_steps[0]
    vb = {k: torch.as_tensor(v, device=DEVICE)
          for k, v in vbatches[0].items()}
    vpair = np.array([0, 1], np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eval_ms = time_ms(torch, lambda: eval_step(vb, vpair, vpair,
                                               compute_y=True),
                      iters=EVAL_TIMED_STEPS, warmup=2)
    emit({"phase": "eval_timing", "card": card, "batch": cfg_f.batch_size,
          "compute_y": True, "step_ms": eval_ms,
          "val_slices_per_s": cfg_f.batch_size / eval_ms * 1e3,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "timed_steps": EVAL_TIMED_STEPS})

    # 19. each BatchNorm kernel per shape, and the train step with the fused
    # and with the unfused BatchNorm
    bn_rows = {"bn_stats": {}, "bn_norm": {}}
    for shape in map(list, dict.fromkeys(tuple(c[1:]) for c in calls)):
        n_step = sum(1 for c in regular if list(c[1:]) == shape)
        n_first = sum(1 for c in calls if list(c[1:]) == shape)
        x, scale, bias = bn_case(torch, shape, torch.bfloat16, args.seed)
        mean, var = fused_bn.bn_stats_cuda(x)
        xs = [x[i] for i in range(shape[0])]
        numel, gc = x.numel(), shape[0] * shape[2]
        rows = {
            "bn_stats": (lambda: fused_bn.bn_stats_cuda(x),
                         lambda: fused_bn.bn_stats_plain(x),
                         lambda: torch.var_mean(x, dim=(1, 3, 4),
                                                correction=0),
                         numel * x.element_size() + 2 * gc * 4),
            "bn_norm": (lambda: fused_bn.bn_norm_cuda(x, mean, var, scale,
                                                      bias, BN_EPS),
                        lambda: fused_bn.bn_norm_plain(x, mean, var, scale,
                                                       bias, BN_EPS),
                        lambda: [F.batch_norm(xs[i], mean[i], var[i], scale,
                                              bias, False, 0.0, BN_EPS)
                                 for i in range(shape[0])],
                        2 * numel * x.element_size() + 2 * gc * 4
                        + 2 * shape[2] * 4)}
        pair_ms = time_ms(torch, lambda: [
            F.batch_norm(xi, None, None, scale, bias, True, 0.0, BN_EPS)
            for xi in xs], iters=20)
        for kname, (kfn, pfn, lfn, nbytes) in rows.items():
            bytes_ms = nbytes / mem_rate * 1e3
            ops_ms = BN_OPS_PER_ELEM * numel / f32_peak * 1e3
            row = {"ms": time_ms(torch, kfn, iters=50),
                   "cold_ms": cold_ms(torch, kfn),
                   "plain_ms": time_ms(torch, pfn, iters=20),
                   "library_ms": time_ms(torch, lfn, iters=20),
                   "device_ms": device_ms(torch, kfn),
                   "plain_device_ms": device_ms(torch, pfn),
                   "library_device_ms": device_ms(torch, lfn),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "operations" if ops_ms > bytes_ms
                   else "bytes", "per_step": n_step,
                   "per_first_step": n_first}
            bn_rows[kname][tuple(shape)] = row
            emit(dict({"phase": "bn_kernel_timing", "kernel": kname,
                       "shape": shape, "dtype": "bf16", "card": card,
                       "launches_per_step": n_step,
                       "launches_per_first_of_epoch_step": n_first,
                       "bytes": nbytes,
                       "bound_share": row["bound_ms"] / row["ms"],
                       "device_bound_share": row["bound_ms"]
                       / row["device_ms"],
                       "batch_norm_train_ms": pair_ms}, **row))
    del x, xs, scale, bias, mean, var

    def bn_totals(kname, key):
        rows = bn_rows[kname].values()
        tot = {m: sum(r[key] * r[m] for r in rows)
               for m in ("ms", "cold_ms", "plain_ms", "library_ms",
                         "bound_ms", "device_ms", "plain_device_ms",
                         "library_device_ms")}
        tot["bound_by"] = ("operations" if any(
            r["bound_by"] == "operations" for r in rows) else "bytes")
        return tot

    windows = {"unfused": [], "fused": []}
    for mode in ("unfused", "fused", "fused", "unfused"):
        mf.set_fuse_bn(mode == "fused")
        windows[mode].append(time_ms(torch, lambda: step_f(batch, gen_f,
                                                           pairs),
                                     iters=TRAIN_TIMED_STEPS // 2, warmup=1))
    mf.set_fuse_bn(True)
    emit({"phase": "train_timing_fused_bn", "card": card,
          "batch": cfg_f.batch_size, "order": "unfused, fused, fused, "
          "unfused", "steps_per_window": TRAIN_TIMED_STEPS // 2,
          "step_ms_fused": float(np.mean(windows["fused"])),
          "step_ms_unfused": float(np.mean(windows["unfused"])),
          "windows_ms": windows,
          "slices_per_s_fused": cfg_f.batch_size
          / float(np.mean(windows["fused"])) * 1e3})

    # the train steps of the remaining configurations
    s2_cfg = config.seg_stage2("timing")
    config_timing(torch, T, card, "train_timing_seg_stage2", s2_cfg,
                  stacked_batch(rng, s2_cfg, "seg"), args.seed)
    zd_cfg = config.zerodose()
    config_timing(torch, T, card, "train_timing_zerodose", zd_cfg,
                  stacked_batch(rng, zd_cfg, "pet"), args.seed)
    adv_cfg = config.flagship()
    for k, v in ADV_LOSSES.items():
        setattr(adv_cfg, k, v)
    config_timing(torch, T, card, "train_timing_adv", adv_cfg.derive(),
                  batch, args.seed)

    # 29-36. the whole-volume 3D path on the run's phantoms
    vol_launches = volume3d_phases(torch, kernels, card, args.seed, store,
                                   f32_peak)
    del store

    print(card, flush=True)
    paths = {"serve": serve_launches, "train": train_launches,
             "train_fused_bn": fused_launches, "eval": eval_launches,
             "train_run": run_launches, "train_run_host": host_launches,
             "train_seg_stage2": stage2_launches,
             "train_zerodose": zd_launches,
             "train_adv_kl": adv["prior_off"],
             "train_adv_kl_prior": adv["prior_on"],
             "train_adv_kl_fused_bn": adv["fused_bn"],
             **test_launches, "test_phase_zerodose": zd_test_launches,
             **vol_launches}
    by_path = lambda k: {p: c[k] for p, c in paths.items()}
    bn_entry = lambda kname, tpu_line, err, note: dict({
        "name": kname, "route": "cuda",
        "source": "representation_disentanglement_torch/csrc/bn_train.cu",
        "replaces": f"representation_disentanglement_tpu/ops/pallas_bn.py:"
                    f"{tpu_line}",
        "launches": sum(by_path(kname).values()),
        "launches_by_path": by_path(kname), "max_abs_err": err,
        "library_note": note,
        "times_are": f"sum over the {BN_CALLS} launches of one fused-BN "
                     "train step (bf16); ms from CUDA events over "
                     "back-to-back calls of the wrapper, device_ms from "
                     "the replay of a CUDA graph of 20 calls",
        "first_of_epoch_step": bn_totals(kname, "per_first_step")},
        **bn_totals(kname, "per_step"))
    emit({"kernels": [{
        "name": "in_modulate", "route": "cuda",
        "source": "representation_disentanglement_torch/csrc/in_modulate.cu",
        "replaces": "representation_disentanglement_tpu/ops/pallas_kernels.py:172",
        "replaces_also": "representation_disentanglement_tpu/ops/pallas_kernels.py:75",
        "launches": sum(by_path("in_modulate").values()),
        "launches_by_path": by_path("in_modulate"),
        "max_abs_err": max_err, "ms": serve_totals["ms"],
        "plain_ms": serve_totals["plain_ms"],
        "bound_ms": serve_totals["bound_ms"],
        "bound_by": "operations" if bound_by_ops else "bytes",
        "cold_ms": serve_totals["cold_ms"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes instance-norm "
                        "plus modulation",
        "times_are": "sum over the six SPADE launches of one serve step; "
                     "cold_ms with the L2 flushed before each launch",
        "train_step": per_step["in_modulate"]}, {
        "name": "in_modulate_bwd", "route": "cuda",
        "source": "representation_disentanglement_torch/csrc/in_modulate.cu",
        "replaces": "representation_disentanglement_tpu/ops/pallas_kernels.py:183",
        "replaces_also": "representation_disentanglement_tpu/ops/pallas_kernels.py:93",
        "launches": sum(by_path("in_modulate_bwd").values()),
        "launches_by_path": by_path("in_modulate_bwd"),
        "max_abs_err": max_err_bwd,
        "ms": per_step["in_modulate_bwd"]["ms"],
        "plain_ms": per_step["in_modulate_bwd"]["plain_ms"],
        "bound_ms": per_step["in_modulate_bwd"]["bound_ms"],
        "cold_ms": per_step["in_modulate_bwd"]["cold_ms"],
        "bound_by": "operations" if bwd_bound_by_ops else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the backward of "
                        "instance-norm plus modulation",
        "times_are": f"sum over the {per_step_expected} backward launches "
                     "of one train step"},
        bn_entry("bn_stats", 46, max(bn_err["stats_abs"],
                                     adv["d_bn_err"]["stats_abs"]),
                 "torch.var_mean over (B, H, W), biased"),
        bn_entry("bn_norm", 69, max(bn_err["y_abs"],
                                    adv["d_bn_err"]["y_abs"]),
                 "F.batch_norm(training=False) per group with K6's "
                 "statistics, summed over the groups")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
