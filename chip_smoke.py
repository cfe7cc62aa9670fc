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
    and f32, and at the edge cases ``BN_EDGE_CASES``, with a second K6
    launch bit-identical to the first (``bn_kernel_check``);
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
    the native gather built here and taken by that epoch, the same epoch
    again with the numpy branch, and ``get_batch`` timed in both branches
    with equal batches (``native_gather``);
18. time the eval step (``eval_timing``);
19. time each BatchNorm kernel per shape beside its bound, its plain
    version and the library calls, by CUDA events over back-to-back calls
    and over the replay of a CUDA graph of the calls, without the host's
    time, and cold: one call after a 256 MiB write between CUDA events
    (``cold_ms``) and in a CUDA graph less the writes (``cold_device_ms``)
    (``bn_kernel_timing``), beside an empty kernel at the same grid
    (``floor_*``, ``bn_launch_floor``), and the train step with the fused and with the
    unfused BatchNorm (``train_timing_fused_bn``).

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

The 2D model options, at the flagship's widths, after phase 23 (random
weights; the VGG paths read a random VGG16 npz written from the seed into
a temporary directory, the pretrained weights not being in the
repository):

37. K1 and K3 against their plain versions at the SPADEFull train grid,
    every block on N = M*M*B = 256 planes (``kernel_check_full``,
    ``kernel_check_bwd_full``);
38. ``train_options_full``: SPADEFull, per-modality anatomy and modality
    encoders, ``mod_enc_s``, 'U+SSA+CA' and ``fuse_bn``: three steps, the
    first the first of its epoch: finite metrics, every parameter reached,
    every BatchNorm statistic moved, 6 launches of K1 and of K3 and 52
    then 40 of K6 and of K7 per step; one step with the kernels against
    the plain versions and with the fused against the unfused BatchNorm;
    the step's ms, slices/s and peak (``train_timing_options_full``); its
    BatchNorm calls, the G = 1 encoder shapes among them;
39. ``train_options_vgg``: the 'vmap' halves, 'U+SA+CA', ``s_sim_method:
    'perceptual'`` and ``s_compact_method: 'vgg'``: the same checks, 15
    launches of K1 and of K3 per step, a nonzero perceptual sim_s;
40. ``train_old``: ``others.old`` (non-conditional convolutions and
    SPADEFull) with 'U': the same checks, 6 launches of K1 and of K3;
41. ``eval_options_full``, ``eval_options_vgg``: ``evaluate`` over two
    batches, 6 / 15 launches of K1 per batch and no BatchNorm kernel;
42. ``serve_options_full``, ``serve_options_vgg``: a request through
    ``serve_requests``, 6 launches of K1 per serve step (N = 64); and
    ``serve_options_retrieval``: the retrieval serve step with the VGG16
    compact key over a bank of the eval batches' codes, each retrieved z a
    bank row;
43. K6 and K7 against their plain versions at every BatchNorm shape of
    ``train_options_full`` and ``train_options_vgg`` (``bn_kernel_check``);
44. K6 and K7 timed at the four G = 1 shapes (``bn_kernel_timing``),
    beside an empty kernel at their grids (``bn_launch_floor``).

The modules beside ``MultimodalModel`` (phases 45-47, after 44), at the
reference's full width (first_num_ch 64), B = 16, bf16, random weights
from the seed and phantom inputs, with ``set_fuse_bn`` on: the deepest
legacy generator (split input, channel attention, symmetry-gate gates) at
3x160x192, ``GANStandardGenerator`` at 1x256x256 (1x1 bottleneck),
``UNet`` and ``LowdoseModel`` at 3x160x192, ``GANShortGeneratorZCond`` at
4x160x192 with z [16, 16] (per-sample CondConv), ``ResNet18`` at 3x160x192
and ``DANet`` at 4x160x192:

45. one train-mode forward and backward of each (``legacy_<name>``): K6
    and K7 once per BatchNorm call, finite output and gradients; the f32
    step against the same step with the plain versions of K6/K7 in their
    place (output at the fused-BatchNorm f32 loss tolerance, gradients at
    its bf16 gradient tolerance), beside the gap one f32 ulp of the means
    opens; each bf16 step (fused, with plain K6/K7, unfused) against the
    unfused f32 step, the first two held within LEGACY_BF16_RATIO of the
    unfused one's gap (rounding); the step's ms and peak memory;
    ``percase_conv2d`` with its bias against a loop of per-sample convs at
    zcond's first layer, rounded as the port and JAX round
    (``percase_conv_check``);
46. K6 and K7 against their plain versions at every BatchNorm shape of
    these models and at ``LEGACY_BN_SHAPES``, bf16 and f32
    (``bn_kernel_check``);
47. K6 and K7 timed at each of those shapes beside bound, plain version,
    library call and launch floor (``bn_kernel_timing``,
    ``bn_launch_floor``).

The slice of the native gather, the custom ops, the AOT artifact, the
JAX package's checkpoints and the tool modules (48 right after the build,
49-53 after the 3D phases):

48. ``torch.library.opcheck`` of ``rdt::in_modulate``,
    ``rdt::in_modulate_bwd``, ``rdt::bn_stats`` and ``rdt::bn_norm`` on the
    card at one flagship shape each, bf16 (``custom_ops``), and the op's
    dispatch against the bare launcher (``custom_ops_dispatch``); the
    kernel checks of phases 3, 10, 37, 43 and 46 call the ops;
49. the flagship serve step exported at B = 16 (``utils/aot.py``), saved
    and loaded in a fresh process that imports only the port
    (``aot_serve``): its output against the live step's (bit-identical,
    or within SERVE_REL_L2), the artifact's bytes, the cold start of the
    artifact (load + first request) and of the live step (build + first
    request, in another fresh process), 6 K1 launches per request through
    it (``launches_by_path.aot_serve``) and its latency;
50. the flagship weights written in the JAX package's checkpoint format
    (flax msgpack, by ``msgpack_pack`` and ``to_jax_flagship`` here) and
    with ``torch.save``, each restored through ``main_missing._restore``
    onto the card (``jax_checkpoint``): every tensor, equal state dicts,
    bit-identical serve outputs;
51. ``serve_latency``'s p50 / p95 / p99 / mean ms and slices/s of the live
    step at B in LATENCY_BATCHES, beside phase 49's AOT row
    (``serve_latency``);
52. ``bench3d`` at ``main_3d``'s defaults in f32 and bf16 (``bench3d``);
53. a ``utils/profiling.trace`` of two serve steps: its Chrome trace holds
    the 12 ``rdt::in_modulate`` calls (``trace``), with
    ``device_memory_stats``; then the script's seconds (``total``).

Phases 6, 9 and 19 also time each kernel with the L2 cache flushed before
every launch (``cold_ms``).

Multi-GPU (``parallel/``), after phase 36, at world size
``torch.cuda.device_count()`` over NCCL: on one card a process group of one
rank in this process (the halo exchange then takes its one-shard branch),
on more cards one process per card; rank 0 holds each result against the
unsharded step on its own card from the same weights and global batch:

54. ``dp_train``, ``dp_train_fused_bn``: the flagship train step (B = 16,
    160x192, bf16) on the rank's B/N rows, the losses of the global batch,
    synchronized BatchNorm (K6 per rank, the statistics combined, K7), the
    gradients averaged: the loss within PAR_LOSS_REL and the weights within
    PAR_PARAM_ATOL of the unsharded step's, K1/K3 launched (and K6/K7 with
    ``fuse_bn`` only), ms per step and peak memory per rank;
55. ``dp_run``: ``main_missing.run`` with ``mesh_shape: {data: N}`` over
    the sharded cache, one epoch and a resume for a second: one row per
    epoch in ``stat.csv`` (rank 0 writes), every tensor and the optimizer
    restored, the cache's bytes per card;
56. ``depth3d``: one NVNet3D step at main_3d's defaults (160x192x64, init
    16, f32) with the depth split over the N cards (halo exchange), and the
    depth-sharded inference, against the unsharded step and forward;
57. ``depth3d_composed`` (4 or more cards): the same on a 2 x N/2 (data x
    depth) mesh at batch 2;
58. ``tp3d``: NVNet3D's forward with each convolution's output channels
    split over the N cards, against the unsharded forward.

And the port's benchmark entry point, after the build:

59. ``bench``: ``python -m representation_disentanglement_torch.bench
    --steps BENCH_STEPS`` in a child process as a benchmark starts it, at
    the flagship defaults and with ``--fuse-bn``: every rate of its last
    line finite and positive, 0 < mfu <= 1 against the card's bf16 dense
    peak, the FLOP count within BENCH_FLOP_BAND of XLA's count of the same
    step (a sanity band; the ratio is printed), the null fields null, and
    its launch line: per train call 15 of each SPADE kernel and no
    BatchNorm kernel (16 of each with ``--fuse-bn``), 15 forward launches
    per infer and val call, 6 per serve call.

Every phase that fails ends the run with a non-zero exit.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.

Run from the root of the repository:  python3 chip_smoke.py [--seed 0]

``python3 chip_smoke.py --options`` builds the kernels and runs only the
options' phases 37-44 (no result line); ``--legacy`` only phases 45-47;
``--parallel`` only phases 54-58, on every visible card.
``python3 chip_smoke.py --bn-timing [--root DIR]`` builds the kernels and
runs only phase 19's ``bn_kernel_timing`` (the flagship's and the
discriminator's BatchNorm shapes, without the launch floor) and prints the
per-step totals; with
``--root`` it times the package of another checkout, e.g. an earlier
commit unpacked with ``git archive``, so that two versions can be timed in
turns on one card.
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
# the options' steps hold the latent-z term absolutely, as the fused check
# below does: under mod_enc_s it is about 1e-4, below the bf16 resolution
# of the z means it averages (measured on an H100 at 700 W: 1.9e-6
# absolute, 1.6% relative, with 2.9e-5 on recon_x)
TRAIN_BF16_LATENT_ATOL = 5e-4
TRAIN_F32_LOSS_REL = 1e-5
TRAIN_F32_GRAD_REL_L2 = 1e-4
BN_EPS = 1e-5
# K6 against its plain version (torch's f32 reductions): the error of the
# mean relative to mean|x|, and of the variance relative to mean(x^2), per
# (group, channel).  Both sum up to 491,520 values in f32, in different
# orders.  Under fused_bn.bn_plan K6 sums each vector of up to 8 values as
# a tree (at most 3 levels), adds the vector sums of its rows in sequence
# (ceil(B * chunks / streams): 128 in the f32 y decoder at 80x96, where
# streams = 1, and in the edge case of 64 samples in two channels), then
# shuffles over a segment of at most 32 lanes (5 levels), then the
# channel's first thread adds the other segments of every stream in
# sequence (at most 15): at most 151 additions on any path of the cases
# checked here (142 in the f32 y decoder), which bounds its error by about
# 151 2^-24 = 9.0e-6 of the sum of magnitudes (torch's reductions add
# fewer)
BN_STATS_REL = 4e-5
# K7 against its plain version from the same statistics: 2^-20 of the
# magnitudes of its terms, |x - mean| |rsqrt(var + eps) scale| + |bias|
# (rsqrt, fused multiply-add, order), plus 2 bf16 ulps of a bf16 output
BN_NORM_REL = 2.0 ** -20
BN_OPS_PER_ELEM = 3     # K6: add, multiply, add; K7: subtract, multiply, add
BN_CALLS_FIRST, BN_CALLS = 28, 16      # per train step: first of an epoch
# the BatchNorm calls of the flagship train step with fuse_bn: x [G, B, C,
# H, W] bf16, launches of K6 and of K7 per step and per first-of-epoch step
# (the anatomy U-Net's two encodes at G=4; the y decoder's at G=5)
FLAGSHIP_BN_SHAPES = [((4, 16, 64, 40, 48), 4, 4), ((4, 16, 128, 20, 24), 4, 4),
                      ((4, 16, 256, 10, 12), 4, 4), ((4, 16, 256, 5, 6), 2, 2),
                      ((4, 16, 32, 80, 96), 2, 2), ((5, 16, 64, 80, 96), 0, 2),
                      ((5, 16, 128, 40, 48), 0, 3),
                      ((5, 16, 256, 20, 24), 0, 3),
                      ((5, 16, 512, 10, 12), 0, 3), ((5, 16, 512, 5, 6), 0, 1)]
# K6/K7 beyond the model's shapes: (x [G, B, C, H, W], x's dtype, scale's
# and bias's dtype, x's offset in values): H*W of 1, 30 and 7, x at a
# 2-byte offset, G*C = 1, B = 1, a slab of 64 samples in two channels (a
# grid of two blocks, the longest sum), f32 x with bf16 parameters
BN_EDGE_CASES = [((3, 4, 300, 1, 1), "bf16", "f32", 0),
                 ((2, 3, 5, 5, 6), "f32", "f32", 0),
                 ((2, 3, 37, 7, 1), "bf16", "bf16", 0),
                 ((4, 16, 64, 40, 48), "bf16", "f32", 1),
                 ((2, 3, 5, 5, 6), "bf16", "f32", 1),
                 ((1, 6, 1, 9, 8), "bf16", "f32", 0),
                 ((4, 1, 8, 80, 96), "bf16", "f32", 0),
                 ((1, 64, 2, 80, 96), "bf16", "f32", 0),
                 ((4, 16, 32, 80, 96), "f32", "bf16", 0)]
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
# the 2D model options (phases 37-44) at the flagship's widths: ``full``
# SPADEFull, per-modality anatomy and modality encoders, mod_enc_s,
# 'U+SSA+CA' and fuse_bn; ``vgg`` the 'vmap' decoder halves, 'U+SA+CA' and
# the VGG similarity paths (a random VGG16 npz from the seed); ``old`` the
# reference's pre-CondConv module set (non-conditional convolutions and
# SPADEFull) with 'U'
OPTION_CFGS = {
    "full": dict(shared_inp_dec=True, shared_ana_enc=False,
                 shared_mod_enc=False, target_model_name="U+SSA+CA",
                 fuse_bn=True, others={"mod_enc_s": True}),
    "vgg": dict(notshared_impl="vmap", target_model_name="U+SA+CA",
                s_compact_method="vgg", s_sim_method="perceptual"),
    "old": dict(target_model_name="U", others={"old": True}),
}
OPTION_PHASES = {"full": "train_options_full", "vgg": "train_options_vgg",
                 "old": "train_old"}
OPTIONS_STEPS = 3                     # a first-of-epoch step and two more
# launches per step, derived from the code: (K1, K3, K6/K7 on the first
# step of an epoch, K6/K7 later).  SPADEFull runs its six blocks once on
# the M*M*B grid; the loop halves 3 + 3*M.  full's BatchNorms: the four
# per-modality anatomy encoders (4 each, G = 1) and the shared decoder half
# (4, G = 4), twice (the latent cycle's re-encode feeds the modality
# encoder under mod_enc_s), and the 'U+SSA+CA' decoder's 12 (G = 5) on the
# first step
OPTION_LAUNCHES = {"full": (6, 6, 52, 40), "vgg": (15, 15, 0, 0),
                   "old": (6, 6, 0, 0)}
# the BatchNorm inputs [G, B, C, H, W] of the per-modality anatomy encoders
# (down_2 .. down_5 at 160x192 / 4 .. / 32), 8 launches of each K6/K7 per
# full step; the 'U+SSA+CA' and 'U+SA+CA' gates' are FLAGSHIP_BN_SHAPES'
OPTIONS_G1_BN_SHAPES = [(1, 16, 64, 40, 48), (1, 16, 128, 20, 24),
                        (1, 16, 256, 10, 12), (1, 16, 256, 5, 6)]
OPTIONS_EVAL_BATCHES = 2
OPTIONS_TIMED_STEPS = 5
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


def cold_device_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn`` with the L2 cache cold, without
    the CUDA events' or the host's own time: ``iters`` (flush, call) pairs
    captured in one CUDA graph, less a graph of the ``iters`` flushes alone
    (a write of L2_FLUSH_BYTES each), over ``iters``; the median of
    ``reps`` replays of each, taken in turns."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            flush.fill_(1)
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for with_fn in (True, False):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                flush.fill_(1)
                if with_fn:
                    fn()
        graphs.append(graph)
    times = ([], [])
    for _ in range(reps):
        for graph, out in zip(graphs, times):
            graph.replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
    del graphs, flush
    return (float(np.median(times[0])) - float(np.median(times[1]))) / iters


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


def check_kernels(torch, kernels, seed: int, shapes=None,
                  phase: str = "kernel_check"):
    """Kernel (through its op ``rdt::in_modulate``) against plain
    (computed in f32 from the same inputs), at the shapes of
    ``kernel_cases``."""
    worst = 0.0
    for name, dtypes, zi, gamma, beta in kernel_cases(torch, seed, shapes):
        got = torch.ops.rdt.in_modulate(zi, gamma, beta, 1e-5)
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
        rec = {"phase": phase, "kernel": "in_modulate",
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


def full_train_shapes(m: int, b: int):
    """(name, N, C, H, W) of each SPADE block in one train step of the
    single shared decoder (SPADEFull: ``shared_inp_dec`` or
    ``others.old``): all six blocks on the M*M*B decode grid."""
    return [(name, m * m * b, c, h, w) for name, c, h, w in SPADE_SHAPES]


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


def check_bwd_kernels(torch, kernels, seed: int, shapes,
                      phase: str = "kernel_check_bwd"):
    """Backward kernel (through its op ``rdt::in_modulate_bwd``) against
    the plain backward computed in f32 from the same inputs; dbeta, g cast
    outside the op, is the train steps' to check."""
    worst = 0.0
    for name, dtypes, zi, gamma, g in bwd_cases(torch, seed, shapes):
        dz, dg = torch.ops.rdt.in_modulate_bwd(zi, gamma, g, 1e-5)
        torch.cuda.synchronize()
        rz, rg, _ = kernels.in_modulate_bwd_plain(zi.float(), gamma.float(),
                                                  g.float())
        tol_dz, tol_dg = bwd_tolerance(torch, zi, gamma, g)
        if zi.dtype == torch.bfloat16:
            tol_dz = tol_dz + bf16_ulps(torch, rz)
        if gamma.dtype == torch.bfloat16:
            tol_dg = tol_dg + bf16_ulps(torch, rg)
        rec = {"phase": phase, "kernel": "in_modulate_bwd",
               "block": name, "dtypes": dtypes, "shape": list(zi.shape),
               "tolerance": f"{BF16_ULPS} bf16 ulps of a bf16 output + "
                            f"2^{int(np.log2(BWD_REL))} x the magnitudes "
                            "of its terms"}
        ok = dz.dtype == zi.dtype and dg.dtype == gamma.dtype
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


def bn_case(torch, shape, dtype, seed: int, pdtype=None, offset: int = 0):
    """(x [G, B, C, H, W] in ``dtype``, scale [C] and bias [C] in
    ``pdtype``, f32 by default) on the card, with per-channel offsets and
    spreads like a convolution's output; x starts ``offset`` values past
    the start of its buffer (2 bytes for offset 1 in bf16: not 16-byte
    aligned)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    c = shape[2]
    rnd = lambda *s: torch.randn(s, generator=gen, device=DEVICE)
    ch = lambda t: t.view(1, 1, c, 1, 1)
    spread = 0.5 + 1.5 * torch.rand(c, generator=gen, device=DEVICE)
    x = (ch(rnd(c)) + ch(spread) * rnd(*shape)).to(dtype)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=DEVICE)
        x = buf[offset:].view(shape).copy_(x)
    scale, bias = 1.0 + 0.5 * rnd(c), 0.5 * rnd(c)
    if pdtype is not None:
        scale, bias = scale.to(pdtype), bias.to(pdtype)
    return x, scale, bias


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


def bn_check(torch, fused_bn, shape, dtype, seed: int, pdtype=None,
             offset: int = 0) -> dict:
    """``bn_errors`` of K6 and K7 on ``bn_case``'s inputs, and whether a
    second K6 launch on the same x gives the same bits (its sums run in an
    order fixed by the plan)."""
    x, scale, bias = bn_case(torch, shape, dtype, seed, pdtype, offset)
    got = bn_norm_from_plain_stats(fused_bn, x, scale, bias)
    again = torch.ops.rdt.bn_stats(x)
    res = bn_errors(torch, fused_bn, x, scale, bias, got)
    res["stats_bitwise_repeat"] = bool(torch.equal(got[0], again[0])
                                       and torch.equal(got[1], again[1]))
    res["ok"] = res["ok"] and res["stats_bitwise_repeat"]
    return res


def bn_norm_from_plain_stats(fused_bn, x, scale, bias):
    """(K6's mean, var, K7's y from the plain statistics), through the ops
    ``rdt::bn_stats`` and ``rdt::bn_norm``."""
    import torch
    mean, var = torch.ops.rdt.bn_stats(x)
    rmean, rvar = fused_bn.bn_stats_plain(x)
    return mean, var, torch.ops.rdt.bn_norm(x, rmean, rvar, scale, bias,
                                            BN_EPS)


BN_TIMED = ("ms", "cold_ms", "cold_device_ms", "device_ms", "plain_ms",
            "plain_device_ms", "library_ms", "library_device_ms",
            "library_cold_device_ms", "bound_ms")
BN_FLOOR_TIMED = ("floor_cold_device_ms", "floor_device_ms")


def bn_kernel_timing(torch, fused_bn, card: str, seed: int, mem_rate: float,
                     f32_peak: float, shapes) -> dict:
    """Time K6 and K7 at each (shape, launches per step, per first-of-epoch
    step) of ``shapes`` in bf16: through the wrapper back to back (``ms``),
    one call after a 256 MiB write (``cold_ms``, CUDA events around the
    call), the replay of a CUDA graph of 20 calls (``device_ms``) and of 20
    (write, call) pairs less the 20 writes (``cold_device_ms``), beside the
    plain versions, the library calls and the bound.  Emits one
    ``bn_kernel_timing`` line per shape and kernel; returns {kernel:
    {shape: row}}."""
    import gc
    gc.collect()                 # no collection pause inside a cold_ms
    gc.disable()                 # window, which would time the host
    try:
        return _bn_kernel_timing(torch, fused_bn, card, seed, mem_rate,
                                 f32_peak, shapes)
    finally:
        gc.enable()


def _bn_kernel_timing(torch, fused_bn, card, seed, mem_rate, f32_peak,
                      shapes):
    import torch.nn.functional as F
    bn_rows = {"bn_stats": {}, "bn_norm": {}}
    for shape, n_step, n_first in shapes:
        shape = list(shape)
        x, scale, bias = bn_case(torch, shape, torch.bfloat16, seed)
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
                   "cold_device_ms": cold_device_ms(torch, kfn),
                   "device_ms": device_ms(torch, kfn),
                   "plain_ms": time_ms(torch, pfn, iters=20),
                   "plain_device_ms": device_ms(torch, pfn),
                   "library_ms": time_ms(torch, lfn, iters=20),
                   "library_device_ms": device_ms(torch, lfn),
                   "library_cold_device_ms": cold_device_ms(torch, lfn),
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
                       "cold_device_bound_share": row["bound_ms"]
                       / max(row["cold_device_ms"], 1e-9),
                       "batch_norm_train_ms": pair_ms}, **row))
        del x, xs, scale, bias, mean, var
    return bn_rows


def bn_floor_timing(torch, fused_bn, kernels, card: str, shapes) -> dict:
    """The floor of a launch of K6 and K7 at each (shape, launches per
    step, per first-of-epoch step) of ``shapes`` in bf16: an empty kernel
    at the kernel's grid and block, launched as the kernel is, cold in a
    CUDA graph less the writes (``floor_cold_device_ms``) and warm
    (``floor_device_ms``).  Emits one ``bn_launch_floor`` line per shape
    and kernel; returns {kernel: {shape: row}}."""
    floor_rows = {"bn_stats": {}, "bn_norm": {}}
    probe = torch.empty(0, device=DEVICE)
    index = probe.device.index
    for shape, n_step, n_first in shapes:
        plan = fused_bn.bn_plan(tuple(shape), 2, 16,
                                fused_bn._sm_count(index))
        grids = {"bn_stats": (plan.blocks(shape), plan.threads),
                 "bn_norm": (fused_bn.bn_norm_blocks(shape, plan.vec),
                             fused_bn.NORM_THREADS)}
        for kname, (blocks, threads) in grids.items():
            empty = lambda: kernels.BN_EMPTY.launch(
                blocks, threads, index, fused_bn._stream(probe), shape=shape)
            row = {"floor_cold_device_ms": cold_device_ms(torch, empty),
                   "floor_device_ms": device_ms(torch, empty),
                   "blocks": blocks, "threads": threads,
                   "per_step": n_step, "per_first_step": n_first}
            floor_rows[kname][tuple(shape)] = row
            emit(dict({"phase": "bn_launch_floor", "kernel": kname,
                       "shape": list(shape), "card": card}, **row))
    return floor_rows


def bn_totals(bn_rows, kname: str, key: str, fields=BN_TIMED) -> dict:
    """Each of ``fields`` of ``bn_rows[kname]`` summed over the shapes,
    weighted by the launches ``key`` ('per_step' or 'per_first_step')."""
    rows = bn_rows[kname].values()
    return {m: sum(r[key] * r[m] for r in rows) for m in fields}


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
        VolumeStore)
    vols, _, _ = synthetic.synthetic_volumes(
        "BraTS", cfg.contrast_list, "z-score", sum(RUN_SUBJECTS),
        (cfg.input_height, cfg.input_width, RUN_DEPTH), seed)
    write_run_folds(cfg, data_path)
    return VolumeStore(data=vols)


def write_run_folds(cfg, data_path: str) -> None:
    """The fold txts of ``train_run_data``'s subjects under ``data_path``."""
    from representation_disentanglement_torch.data import synthetic
    from representation_disentanglement_torch.data.dataset import (
        fold_txt_names)
    from representation_disentanglement_torch.data.preprocess import (
        write_fold_txts)
    subjects = [f"BraTS20_Training_{i:03d}" for i in range(sum(RUN_SUBJECTS))]
    n_train, n_val, _ = RUN_SUBJECTS
    write_fold_txts(
        synthetic.one_fold((subjects[:n_train],
                            subjects[n_train:n_train + n_val],
                            subjects[n_train + n_val:]), RUN_SLICES),
        data_path, synthetic.by_split(
            fold_txt_names("BraTS", cfg.fold, cfg.modality_num)))


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
        native_gather_phase(torch, main_missing, card, run_cfg, tmp, store,
                            out_h)
        launches_s2 = seg_stage2_phase(torch, kernels, card, seed, store, d,
                                       tmp)
        launches_t = test_phases(torch, kernels, card, store, tmp, d, root,
                                 run_cfg)
        return launches, launches_h, launches_s2, launches_t, store
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def native_gather_phase(torch, main_missing, card: str, run_cfg, tmp: str,
                        store, out_h: dict) -> None:
    """Phase ``native_gather``: the host gather (``native``) builds here and
    ``train_run_host``'s epoch took it; the same epoch again with the numpy
    branch (``native.available`` False); and ``get_batch`` of the train
    fold timed in both branches over NATIVE_TIMED_BATCHES batches, their
    batches equal."""
    import os
    from representation_disentanglement_torch import native
    t0 = time.perf_counter()
    available = native.available()
    build_s = time.perf_counter() - t0
    check(available and out_h["gather"] == "native",
          f"the native gather: available {available}, the host epoch took "
          f"{out_h['gather']}")
    real = native.available
    native.available = lambda: False
    try:
        host = run_cfg(tmp, device_data_cache=False, epochs=1)
        out_n = main_missing.run(host, ckpt_root=os.path.join(tmp, "numpy"),
                                 store=store, device=DEVICE)
        torch.cuda.synchronize()
    finally:
        native.available = real
    check(out_n["gather"] == "numpy", f"numpy epoch took {out_n['gather']}")
    cfg = run_cfg(tmp, device_data_cache=False).derive().validate()
    ds = main_missing.make_loaders(cfg, DEVICE, store)[0].dataset
    ds.dropoff = False                      # equal batches in both branches
    rows = np.random.default_rng(0).permutation(len(ds))
    batches = [rows[i * cfg.batch_size:(i + 1) * cfg.batch_size].tolist()
               for i in range(NATIVE_TIMED_BATCHES)]
    per_branch, first = {}, {}
    ds.get_batch(batches[0])                          # packs the volumes
    for branch in ("native", "numpy"):
        ds._packed["native_ok"] = branch == "native"
        t0 = time.perf_counter()
        outs = [ds.get_batch(b) for b in batches]
        per_branch[branch] = (time.perf_counter() - t0) / len(batches)
        check(ds.gather_branch == branch, f"get_batch took "
                                          f"{ds.gather_branch}")
        first[branch] = outs[0]
    same = all(np.array_equal(first["native"][k], first["numpy"][k])
               for k in ("inputs", "targets", "mask", "mask_img"))
    emit({"phase": "native_gather", "card": card, "available_s": build_s,
          "epoch_train_s": {"native": out_h["epochs"][0]["train_s"],
                            "numpy": out_n["epochs"][0]["train_s"]},
          "epoch_slices_per_s": {
              "native": out_h["epochs"][0]["slices_per_s"],
              "numpy": out_n["epochs"][0]["slices_per_s"]},
          "get_batch_ms": {k: v * 1e3 for k, v in per_branch.items()},
          "batch": cfg.batch_size, "timed_batches": NATIVE_TIMED_BATCHES,
          "threads": os.environ.get("RDT_NATIVE_THREADS",
                                    str(os.cpu_count())),
          "batches_equal": same})
    check(same, "the native and numpy gathers give other batches")


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
    from representation_disentanglement_torch.data.preprocess import (
        write_fold_txts)
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
        write_fold_txts(
            synthetic.one_fold((subjects[:n_train],
                                subjects[n_train:n_train + n_val],
                                subjects[n_train + n_val:]), RUN_SLICES),
            tmp, synthetic.by_split(
                fold_txt_names("ZeroDose", cfg.fold, cfg.modality_num)))
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
            res = bn_check(torch, fused_bn, shape, dtype, seed + 100 + k)
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
    from representation_disentanglement_torch.data.dataset import (
        fold_txt_names)
    from representation_disentanglement_torch.data.preprocess import (
        write_fold_txts)
    from representation_disentanglement_torch.training import checkpoint
    from representation_disentanglement_torch.utils import preempt

    n_train, n_val, n_test = VOL_RUN_SUBJECTS
    picked = subjects[:n_train + n_val + n_test]
    write_fold_txts(
        synthetic.one_fold((picked[:n_train], picked[n_train:n_train + n_val],
                            picked[n_train + n_val:]), (62, 63)),
        tmp, synthetic.by_split(fold_txt_names("BraTS", 0, 4)))
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


def write_vgg_npz(path: str, seed: int) -> str:
    """Random VGG16 'features' weights from ``seed`` in the npz format of
    ``models.vgg.dump_torchvision_vgg16`` (He-scaled); the pretrained
    weights are not in the repository."""
    from representation_disentanglement_torch.models.vgg import VGG16_PLAN
    rs = np.random.default_rng(seed)
    out, ci, i = {}, 3, 0
    for item in VGG16_PLAN:
        if item == "M":
            continue
        out[f"conv{i}_kernel"] = (rs.standard_normal((3, 3, ci, item),
                                                     dtype=np.float32)
                                  * np.float32(np.sqrt(2.0 / (9 * ci))))
        out[f"conv{i}_bias"] = 0.01 * rs.standard_normal(item,
                                                          dtype=np.float32)
        ci, i = item, i + 1
    np.savez(path, **out)
    return path


def option_cfg(name: str, vgg_npz: str):
    """The flagship with option set ``name`` of OPTION_CFGS."""
    from representation_disentanglement_torch import config
    base = config.flagship()
    kw = dict(OPTION_CFGS[name])
    kw["others"] = dict(base.others, **kw.get("others", {}))
    if name == "vgg":
        kw["vgg_npz"] = vgg_npz
    return copy_cfg(base, **kw).derive().validate()


def options_phases(torch, kernels, fused_bn, card: str, seed: int, rng,
                   mem_rate: float, f32_peak: float) -> dict:
    """Phases 37-44, the 2D model options: K1/K3 against plain at the
    SPADEFull train grid (``kernel_check_full``, ``kernel_check_bwd_full``);
    for each configuration of OPTION_CFGS OPTIONS_STEPS steps (``train_
    options_full``, ``train_options_vgg``, ``train_old``: launches per step,
    finite metrics, every parameter reached, every BatchNorm statistic
    moved), one step with the kernels against the plain versions (and, under
    fuse_bn, fused against unfused BatchNorm), the step's ms, slices/s and
    peak (``train_timing_options_*``); for full and vgg the BatchNorm calls
    (K6/K7 against plain at each of their shapes, ``bn_kernel_check``),
    ``evaluate`` (``eval_options``) and a serve request (``serve_options``),
    for vgg the retrieval serve step with the VGG key; K6/K7 timed at the
    G = 1 shapes.  Returns the launches per path, the worst errors and the
    timing rows."""
    import os
    import shutil
    import tempfile
    from representation_disentanglement_torch import serve
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.training import evaluate as E
    from representation_disentanglement_torch.training import train as T
    out = {"launches": {}, "bn_err": {"stats_abs": 0.0, "y_abs": 0.0}}
    fshapes = full_train_shapes(4, 16)
    out["max_err"] = check_kernels(torch, kernels, seed, fshapes,
                                   phase="kernel_check_full")
    out["max_err_bwd"] = check_bwd_kernels(torch, kernels, seed, fshapes,
                                           phase="kernel_check_bwd_full")
    tmp = tempfile.mkdtemp(prefix="rdt_options_")
    bn_shapes = {}
    try:
        npz = write_vgg_npz(os.path.join(tmp, "vgg16_random.npz"), seed)
        for name in ("full", "vgg", "old"):
            phase = OPTION_PHASES[name]
            cfg = option_cfg(name, npz)
            M, B = cfg.modality_num, cfg.batch_size
            model = build_model(cfg, device=DEVICE,
                                generator=torch.Generator().manual_seed(seed))
            batch = train_batch(rng, cfg)
            pairs = T.draw_pairs(np.random.default_rng(seed), M, 1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (step, gen, history, per_step, launches, unreached,
             unmoved) = run_train(torch, kernels, T, model, cfg, batch,
                                  pairs, seed, steps=OPTIONS_STEPS)
            k1, k3, bn_first, bn = OPTION_LAUNCHES[name]
            want = [{"in_modulate": k1, "in_modulate_bwd": k3,
                     "bn_stats": n, "bn_norm": n}
                    for n in [bn_first] + [bn] * (OPTIONS_STEPS - 1)]
            emit({"phase": phase, "card": card, "config": OPTION_CFGS[name],
                  "steps": OPTIONS_STEPS, "batch": B, "metrics": history,
                  "launches_per_step": per_step,
                  "launches_per_step_expected": want, "launches": launches,
                  "unreached_params": unreached, "unmoved_bn_stats": unmoved,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
            out["launches"][phase] = launches
            for h in history:
                check(all(np.isfinite(v) for v in h.values()),
                      f"{phase}: non-finite metrics {h}")
            check(not unreached, f"{phase}: parameters without gradient "
                                 f"{unreached[:5]}")
            check(not unmoved, f"{phase}: BatchNorm statistics that did not "
                               f"move {unmoved[:5]}")
            check(per_step == want, f"{phase}: launches per step "
                                    f"{per_step}; expected {want}")
            if name == "vgg":
                check(all(h["sim_s"] != 0.0 for h in history),
                      f"{phase}: the perceptual sim_s is zero")
            loss_rel, loss_abs, grad_rel, leaf_med, leaf_max = \
                compare_one_step(torch, T, model, cfg, batch, pairs[0], seed,
                                 model.set_use_pallas)
            emit({"phase": phase + "_kernel_vs_plain", "dtype": "bf16",
                  "loss_rel": loss_rel, "latent_z_abs": loss_abs["latent_z"],
                  "grad_rel_l2": grad_rel,
                  "grad_leaf_rel_l2_median": leaf_med,
                  "grad_leaf_rel_l2_max": leaf_max,
                  "tolerance": {"loss_rel": TRAIN_BF16_LOSS_REL,
                                "latent_z_abs": TRAIN_BF16_LATENT_ATOL,
                                "grad_rel_l2": TRAIN_BF16_GRAD_REL_L2}})
            check(max(v for k, v in loss_rel.items() if k != "latent_z")
                  <= TRAIN_BF16_LOSS_REL
                  and loss_abs["latent_z"] <= TRAIN_BF16_LATENT_ATOL
                  and grad_rel <= TRAIN_BF16_GRAD_REL_L2,
                  f"{phase}: kernel and plain interiors disagree")
            if cfg.fuse_bn:
                loss_rel, loss_abs, grad_rel, leaf_med, leaf_max = \
                    compare_one_step(torch, T, model, cfg, batch, pairs[0],
                                     seed, model.set_fuse_bn)
                emit({"phase": phase + "_fused_vs_unfused", "dtype": "bf16",
                      "loss_rel": loss_rel,
                      "latent_z_abs": loss_abs["latent_z"],
                      "grad_rel_l2": grad_rel,
                      "grad_leaf_rel_l2_median": leaf_med,
                      "grad_leaf_rel_l2_max": leaf_max,
                      "tolerance": {"loss_rel": FUSED_BF16_LOSS_REL,
                                    "latent_z_abs": FUSED_BF16_LATENT_ATOL,
                                    "grad_rel_l2": FUSED_BF16_GRAD_REL_L2}})
                check(max(v for k, v in loss_rel.items() if k != "latent_z")
                      <= FUSED_BF16_LOSS_REL
                      and loss_abs["latent_z"] <= FUSED_BF16_LATENT_ATOL
                      and grad_rel <= FUSED_BF16_GRAD_REL_L2,
                      f"{phase}: fused and unfused BatchNorm disagree")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(torch, lambda: step(batch, gen, pairs),
                         iters=OPTIONS_TIMED_STEPS, warmup=1)
            out[name + "_timing"] = rec = {
                "phase": "train_timing_options_" + name, "card": card,
                "batch": B, "step_ms": ms, "slices_per_s": B / ms * 1e3,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "timed_steps": OPTIONS_TIMED_STEPS}
            emit(rec)
            if name != "old":
                calls = bn_calls(torch, T, model, cfg, batch, pairs[0])
                regular = [c for c in calls
                           if not c[0].startswith("output_decoder")]
                emit({"phase": phase + "_bn_calls",
                      "calls_first_of_epoch": len(calls),
                      "calls": len(regular),
                      "shapes": sorted({tuple(c[1:]) for c in calls})})
                if cfg.fuse_bn:
                    check((len(calls), len(regular)) == (bn_first, bn),
                          f"{phase}: {len(calls)} / {len(regular)} "
                          f"BatchNorm calls; expected {bn_first} / {bn}")
                    g1 = sorted({tuple(c[1:]) for c in calls if c[1] == 1})
                    check(g1 == sorted(OPTIONS_G1_BN_SHAPES),
                          f"{phase}: G = 1 BatchNorm shapes {g1}")
                for c in calls:
                    bn_shapes.setdefault(tuple(c[1:]), c[0])
                out["launches"].update(options_inference(
                    torch, kernels, serve, E, T, model, cfg, name, card,
                    rng, k1))
            del model, step
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # bn_kernel_check at every BatchNorm shape of full and vgg
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for k, (shape, site) in enumerate(sorted(bn_shapes.items())):
        for dt in ("bf16", "f32"):
            res = bn_check(torch, fused_bn, list(shape), dtypes[dt],
                           seed + 200 + k)
            out["bn_err"]["stats_abs"] = max(out["bn_err"]["stats_abs"],
                                             res["stats_max_abs_err"])
            out["bn_err"]["y_abs"] = max(out["bn_err"]["y_abs"],
                                         res["y_max_abs_err"])
            emit(dict({"phase": "bn_kernel_check", "site": site,
                       "paths": "train_options_full, train_options_vgg",
                       "shape": list(shape), "dtype": dt}, **res))
            check(res["ok"], f"BatchNorm kernels disagree with plain at "
                             f"the options' {shape} {dt}")
    g1 = [(s, 8, 8) for s in OPTIONS_G1_BN_SHAPES]
    out["bn_g1_rows"] = bn_kernel_timing(torch, fused_bn, card, seed,
                                         mem_rate, f32_peak, g1)
    out["bn_g1_floor"] = bn_floor_timing(torch, fused_bn, kernels, card, g1)
    return out


def options_inference(torch, kernels, serve, E, T, model, cfg, name: str,
                      card: str, rng, k1: int) -> dict:
    """``eval_options_<name>``: ``evaluate`` over OPTIONS_EVAL_BATCHES
    batches (k1 launches of K1 per batch, no BatchNorm kernel);
    ``serve_options_<name>``: one request, 6 launches of K1 per serve step
    at N = M*B; for vgg, ``serve_options_retrieval``: the retrieval serve
    step with the VGG compact key over a bank of the eval batches' codes,
    each retrieved z a bank row.  Returns their launches."""
    from representation_disentanglement_torch import losses as L
    M, B, H, W = (cfg.modality_num, cfg.batch_size, cfg.input_height,
                  cfg.input_width)
    res = {}
    vb = eval_batches(rng, cfg, OPTIONS_EVAL_BATCHES)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stat = E.evaluate(model, cfg, vb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["eval_options_" + name] = launches = kernels.launch_counts()
    emit({"phase": "eval_options_" + name, "card": card,
          "batches": OPTIONS_EVAL_BATCHES, "stat": stat, "wall_s": wall,
          "launches": launches})
    check(all(np.isfinite(stat[k]) for k in T.LOSS_KEYS),
          f"eval_options_{name}: non-finite losses {stat}")
    check(launches == {"in_modulate": k1 * OPTIONS_EVAL_BATCHES,
                       "in_modulate_bwd": 0, "bn_stats": 0, "bn_norm": 0},
          f"eval_options_{name}: launches {launches}")
    inputs = phantoms(rng, M, B, H, W, cfg.block_ch)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r = serve.serve_requests(model, cfg, inputs, missing=["T1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["serve_options_" + name] = launches = kernels.launch_counts()
    emit({"phase": "serve_options_" + name, "card": card, "slices": B,
          "steps": r["steps"], "wall_s": wall, "launches": launches})
    for c, vol in r["x_hat"].items():
        check(vol.shape == (B, H, W) and bool(np.isfinite(vol).all())
              and float(vol.std()) > 0, f"serve_options_{name}: x_hat[{c}]")
    check(launches == {"in_modulate": 6 * r["steps"], "in_modulate_bwd": 0,
                       "bn_stats": 0, "bn_norm": 0},
          f"serve_options_{name}: launches {launches}")
    if name != "vgg":
        return res
    # a bank of the eval batches' anatomy codes and z, keyed by VGG16
    model.eval()
    s_list, z_list = [], []
    with torch.no_grad():
        for b in vb:
            cb = T.prepare_batch(b, model.device, cfg)
            o = model(cb["inputs"], cb["mask"], cb["mask_img"], None,
                      compute_y=False, latent_cycle=False)
            s_list.append(o["s"].float().permute(1, 0, 4, 2, 3).cpu())
            z_list.append(o["z"].float().transpose(0, 1).cpu())
    bank = (torch.cat(s_list).numpy(), torch.cat(z_list).numpy())
    key, zb = serve.load_z_bank(None, cfg, 1, bank=bank, device=model.device,
                                vgg_ctx=T.make_vgg_ctx(model, cfg))
    step = serve.make_serve_step_retrieval(model, cfg, 1, [0],
                                           "nearest_neighbour")
    mask = np.ones((B, M), np.float32)
    mask[:, 0] = 0.0
    x = inputs.copy()
    x[0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    kernels.reset_launch_counts()
    x_hat, y = step(x, mask, mask_img, key, zb)
    torch.cuda.synchronize()
    res["serve_options_retrieval"] = launches = kernels.launch_counts()
    with torch.no_grad():
        xs = torch.as_tensor(x, device=model.device).to(torch.bfloat16)
        s = model.encode_anatomy(xs, torch.as_tensor(
            mask_img, device=model.device))
        q = L.compact_s(s[1].float(), "vgg", T.make_vgg_ctx(model, cfg))
        picked = L.nearest_neighbour_z_by_s(key, zb[:, 0], q)
    in_bank = bool(torch.stack([(zb[:, 0] == p).all(-1).any()
                                for p in picked]).all())
    emit({"phase": "serve_options_retrieval", "card": card,
          "bank_rows": int(key.shape[0]), "key_dim": int(key.shape[1]),
          "launches": launches, "z_in_bank": in_bank})
    check(tuple(key.shape) == (OPTIONS_EVAL_BATCHES * B, 512),
          f"serve_options_retrieval: VGG bank keys {tuple(key.shape)}")
    check(bool(torch.isfinite(x_hat).all()) and bool(torch.isfinite(y).all())
          and in_bank, "serve_options_retrieval: outputs or retrieval")
    check(launches == {"in_modulate": 6, "in_modulate_bwd": 0,
                       "bn_stats": 0, "bn_norm": 0},
          f"serve_options_retrieval: launches {launches}")
    return res


# the modules beside MultimodalModel (phases 45-47), at the reference's
# full width (first_num_ch 64), B = 16, bf16, seeded weights and phantom
# inputs, every BatchNorm through K6/K7 (set_fuse_bn): name -> (model
# factory, input shape [B, C, H, W], extra input shape or None)
LEGACY_B, LEGACY_WIDTH = 16, 64
LEGACY_MODELS = {
    "split_ca_all_sa": ("legacy_generators", (LEGACY_B, 3, 160, 192), None),
    "standard": ("legacy", (LEGACY_B, 1, 256, 256), None),
    "unet": ("legacy", (LEGACY_B, 3, 160, 192), None),
    "lowdose": ("legacy", (LEGACY_B, 3, 160, 192), None),
    "zcond": ("zcond_generator", (LEGACY_B, 4, 160, 192), (LEGACY_B, 16)),
    "resnet18": ("resnet", (LEGACY_B, 3, 160, 192), None),
    "danet": ("danet", (LEGACY_B, 4, 160, 192), None),
}
# K6/K7 at the grids the earlier configurations never gave them: fewer
# tiles than SMs over 16x160x192 planes (G*C = 32, 64), and planes of 1
# and 4 values at C = 512 (GANStandardGenerator's down_8 and down_7)
LEGACY_BN_SHAPES = [(1, 16, 32, 160, 192), (1, 16, 64, 160, 192),
                    (1, 16, 512, 1, 1), (1, 16, 512, 2, 2)]
LEGACY_TIMED_STEPS = 3
# a bf16 step with K6/K7 (or their plain versions) may lie this much
# further from the f32 step than the unfused bf16 step does (output and
# gradients, relative L2)
LEGACY_BF16_RATIO = 1.5


def legacy_model(torch, name: str, gen):
    """The port's model ``name`` of LEGACY_MODELS at full width on the
    card."""
    from representation_disentanglement_torch.models import (
        danet, legacy, legacy_generators, resnet, zcond_generator)
    kw = dict(gen=gen, device=DEVICE)
    if name == "split_ca_all_sa":
        return legacy_generators.\
            GANShortGeneratorWithSplitInputChannelAttentionAllAndSpatialAttention(
                1, 3, LEGACY_WIDTH, **kw)
    if name == "standard":
        return legacy.GANStandardGenerator(1, 1, LEGACY_WIDTH, **kw)
    if name == "unet":
        return legacy.UNet(3, 1, LEGACY_WIDTH, **kw)
    if name == "lowdose":
        return legacy.LowdoseModel(3, **kw)
    if name == "zcond":
        return zcond_generator.GANShortGeneratorZCond(4, 1, LEGACY_WIDTH, 16,
                                                      **kw)
    if name == "resnet18":
        return resnet.ResNet18(3, 1, **kw)
    return danet.DANet(4, 4, **kw)


def legacy_step(torch, model, inputs, weight):
    """One train-mode forward and backward of sum(y * weight) / y.numel();
    returns (y as f32, [gradient of each parameter, f32, zeros where
    none])."""
    model.zero_grad(set_to_none=True)
    y = model(*inputs)
    y = (y[0] if isinstance(y, tuple) else y).float()
    (y * weight).sum().div(y.numel()).backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.float()
             for p in model.parameters()]
    return y.detach(), grads


def legacy_gaps(torch, a, b) -> tuple:
    """(output, gradients) of ``a`` against ``b`` as relative L2 gaps, the
    gradients' over all parameters at once."""
    num = torch.sqrt(sum((x - y).square().sum() for x, y in zip(a[1], b[1])))
    den = torch.sqrt(sum(y.square().sum() for y in b[1]))
    return (float((a[0] - b[0]).norm() / b[0].norm().clamp_min(1e-30)),
            float(num / den.clamp_min(1e-30)))


class bn_launchers:
    """Within: the CUDA implementations of ``rdt::bn_stats`` and
    ``rdt::bn_norm`` run ``stats`` and ``norm`` in the place of K6 and K7
    (the same ops and backward, nothing launched)."""

    def __init__(self, fused_bn, stats, norm):
        self.fused_bn, self.fns = fused_bn, (stats, norm)

    def __enter__(self):
        fb = self.fused_bn
        self.real = fb.bn_stats_cuda, fb.bn_norm_cuda
        fb.bn_stats_cuda, fb.bn_norm_cuda = self.fns

    def __exit__(self, *exc):
        self.fused_bn.bn_stats_cuda, self.fused_bn.bn_norm_cuda = self.real


def bn_stats_exact(x, ulps: int = 0):
    """The statistics of ``bn_stats_plain`` summed in f64 and rounded once
    to f32, the mean then moved by ``ulps`` f32 ulps (toward +inf)."""
    import torch
    mean, var = (t.float() for t in (x.double().mean(dim=(1, 3, 4)),
                                     x.double().square().mean(dim=(1, 3, 4))
                                     - x.double().mean(dim=(1, 3, 4))
                                     .square()))
    for _ in range(ulps):
        mean = torch.nextafter(mean, torch.full_like(mean, float("inf")))
    return mean, var


def legacy_phases(torch, kernels, fused_bn, card: str, seed: int,
                  mem_rate: float, f32_peak: float) -> dict:
    """Phases 45-47: for each model of LEGACY_MODELS one train-mode
    forward and backward in bf16 with set_fuse_bn on (``legacy_<name>``):
    K6 and K7 launched once per BatchNorm call (forward pre-hooks count
    the calls) and finite outputs and gradients; the step in f32 with K6
    and K7 against the same step with their plain versions in their place
    (``bn_launchers``): the output within the fused-BatchNorm f32 loss
    tolerance, the gradients within its bf16 gradient tolerance.  Those
    gradients hang on the last bits of the statistics: beside the gap,
    the gap that moving every mean by one f32 ulp opens between two steps
    with exactly rounded statistics (``bn_stats_exact``) is recorded, as
    are the same comparison in bf16 and the fused against the unfused
    BatchNorm in bf16 and f32 (the unfused path rounds each channel's
    scale and shift to bf16, as JAX's does); the step's ms and peak
    memory; then K6/K7 against their plain versions at every
    BatchNorm shape of these models and at LEGACY_BN_SHAPES, bf16 and f32
    (``bn_kernel_check``), and timed at each shape with its bound, library
    call and launch floor (``bn_kernel_timing``, ``bn_launch_floor``); and
    ``percase_conv2d`` against a loop of per-sample F.conv2d at zcond's
    first layer (``percase_conv_check``).  Returns the launches per path,
    the worst errors and the timing rows."""
    import torch.nn.functional as F
    from representation_disentanglement_torch.models import layers
    from representation_disentanglement_torch.ops.conv import percase_conv2d
    out = {"launches": {}, "bn_err": {"stats_abs": 0.0, "y_abs": 0.0}}
    shapes = {}
    rng = np.random.default_rng(seed)
    for name, (family, xshape, zshape) in LEGACY_MODELS.items():
        phase = "legacy_" + name
        model = legacy_model(torch, name, torch.Generator().manual_seed(seed))
        model.train()
        x = torch.as_tensor(phantoms(rng, 1, xshape[0], xshape[2], xshape[3],
                                     xshape[1])[0], device=DEVICE)
        inputs = [x.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)]
        if zshape is not None:
            inputs.append(torch.as_tensor(rng.standard_normal(zshape),
                                          dtype=torch.float32, device=DEVICE))
        inputs32 = [inputs[0].float()] + inputs[1:]
        calls, hooks = [], []
        for mod_name, mod in model.named_modules():
            if isinstance(mod, layers.BatchNormTorch):
                hooks.append(mod.register_forward_pre_hook(
                    lambda m, a, n=mod_name: calls.append(
                        (n, 1) + tuple(a[0].shape))))
        with torch.no_grad():
            y0 = model(*inputs)
        y0 = y0[0] if isinstance(y0, tuple) else y0
        weight = torch.as_tensor(rng.standard_normal(tuple(y0.shape)),
                                 dtype=torch.float32, device=DEVICE)
        layers.set_fuse_bn(model, True)
        torch.cuda.synchronize()
        calls.clear()
        kernels.reset_launch_counts()
        kern = legacy_step(torch, model, inputs, weight)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        n_bn = len(calls)
        for h in hooks:
            h.remove()
        for c in calls:
            shapes.setdefault(c[1:], f"{phase}:{c[0]}")
        kern32 = legacy_step(torch, model, inputs32, weight)
        plain_fns = (fused_bn.bn_stats_plain, fused_bn.bn_norm_plain)
        with bn_launchers(fused_bn, *plain_fns):
            plain = legacy_step(torch, model, inputs, weight)
            plain32 = legacy_step(torch, model, inputs32, weight)
        with bn_launchers(fused_bn, bn_stats_exact, plain_fns[1]):
            exact32 = legacy_step(torch, model, inputs32, weight)
        with bn_launchers(fused_bn, lambda t: bn_stats_exact(t, 1),
                          plain_fns[1]):
            ulp32 = legacy_step(torch, model, inputs32, weight)
        layers.set_fuse_bn(model, False)
        unfused = legacy_step(torch, model, inputs, weight)
        unfused32 = legacy_step(torch, model, inputs32, weight)
        layers.set_fuse_bn(model, True)
        vs_plain32 = legacy_gaps(torch, kern32, plain32)
        gaps = {"f32_kernel_vs_plain": vs_plain32,
                "f32_one_ulp_of_the_means": legacy_gaps(torch, ulp32,
                                                        exact32),
                "bf16_kernel_vs_plain": legacy_gaps(torch, kern, plain),
                "f32_fused_vs_unfused": legacy_gaps(torch, kern32,
                                                    unfused32),
                "bf16_fused_vs_unfused": legacy_gaps(torch, kern, unfused)}
        # each bf16 step against the f32 step of the same weights (the
        # unfused one: no kernel in it)
        vs_f32 = {k: legacy_gaps(torch, v, unfused32) for k, v in (
            ("fused", kern), ("plain", plain), ("unfused", unfused))}
        gaps.update({f"bf16_{k}_vs_f32": v for k, v in vs_f32.items()})
        finite = bool(torch.isfinite(kern[0]).all()) and all(
            bool(torch.isfinite(g).all()) for g in kern[1])
        del kern32, plain, plain32, exact32, ulp32, unfused, unfused32
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: legacy_step(torch, model, inputs,
                                                weight),
                     iters=LEGACY_TIMED_STEPS, warmup=1)
        rec = {"phase": phase, "card": card, "dtype": "bf16",
               "input": list(xshape), "z": zshape and list(zshape),
               "output": list(kern[0].shape),
               "params": sum(p.numel() for p in model.parameters()),
               "bn_calls": n_bn, "launches": launches,
               "out_grad_rel_l2": gaps,
               "tolerance_f32_kernel_vs_plain": [FUSED_F32_LOSS_REL,
                                                 FUSED_BF16_GRAD_REL_L2],
               "tolerance_bf16_vs_f32": f"fused and plain within "
                                        f"{LEGACY_BF16_RATIO} x unfused",
               "finite": finite, "step_ms": ms,
               "samples_per_s": xshape[0] / ms * 1e3,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit(rec)
        out["launches"][phase] = launches
        check(finite, f"{phase}: non-finite output or gradient")
        check(n_bn > 0 and launches["bn_stats"] == n_bn
              and launches["bn_norm"] == n_bn
              and launches["in_modulate"] == 0,
              f"{phase}: launches {launches} for {n_bn} BatchNorm calls")
        check(vs_plain32[0] <= FUSED_F32_LOSS_REL
              and vs_plain32[1] <= FUSED_BF16_GRAD_REL_L2,
              f"{phase}: the f32 step with K6/K7 and with their plain "
              f"versions disagree {vs_plain32}")
        # the bf16 gaps are rounding where the fused step (and the one with
        # plain K6/K7) lies no further from f32 than the unfused one
        for k in ("fused", "plain"):
            check(all(a <= LEGACY_BF16_RATIO * b for a, b in zip(
                vs_f32[k], vs_f32["unfused"])),
                f"{phase}: the bf16 {k} step lies further from the f32 "
                f"step {vs_f32[k]} than {LEGACY_BF16_RATIO} x the unfused "
                f"one's {vs_f32['unfused']}")
        if name == "zcond":
            # the per-sample mixed kernels of down_1 against a loop
            conv = model.down_1.requires_grad_(False)
            w = torch.einsum("ne,eoihw->noihw", torch.sigmoid(
                inputs[1] @ conv._routing_fn.fc.weight.t()
                + conv._routing_fn.fc.bias), conv.weight)
            got = percase_conv2d(inputs[0], w, conv.bias, 2, 1).float()
            # rounded where the port and JAX round: the conv to bf16, then
            # the bf16 bias added in bf16
            raw = torch.cat([F.conv2d(
                inputs[0][i:i + 1].float(), w[i].to(torch.bfloat16).float(),
                None, 2, 1) for i in range(xshape[0])])
            ref = (raw.to(torch.bfloat16) + conv.bias.to(torch.bfloat16)[
                :, None, None]).float()
            # bf16 ulps of the conv and of the output, and f32 sums of 64
            # products
            err = float(((got - ref).abs() - bf16_tolerance(torch, raw)
                         - bf16_tolerance(torch, ref)
                         - 1e-4 * ref.abs().amax()).max())
            emit({"phase": "percase_conv_check", "card": card,
                  "x": list(xshape), "max_abs_err": float(
                      (got - ref).abs().max()),
                  "ref_max_abs": float(ref.abs().max())})
            check(err <= 0, "percase_conv2d disagrees with the loop")
        del model, inputs, inputs32, kern, y0, weight
        torch.cuda.empty_cache()

    for s in LEGACY_BN_SHAPES:
        shapes.setdefault(tuple(s), "LEGACY_BN_SHAPES")
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for k, (shape, site) in enumerate(sorted(shapes.items())):
        for dt in ("bf16", "f32"):
            res = bn_check(torch, fused_bn, list(shape), dtypes[dt],
                           seed + 300 + k)
            out["bn_err"]["stats_abs"] = max(out["bn_err"]["stats_abs"],
                                             res["stats_max_abs_err"])
            out["bn_err"]["y_abs"] = max(out["bn_err"]["y_abs"],
                                         res["y_max_abs_err"])
            emit(dict({"phase": "bn_kernel_check", "site": site,
                       "shape": list(shape), "dtype": dt}, **res))
            check(res["ok"], f"BatchNorm kernels disagree with plain at "
                             f"{site} {shape} {dt}")
    timed = [(s, 1, 1) for s in sorted(shapes)]
    out["bn_rows"] = bn_kernel_timing(torch, fused_bn, card, seed, mem_rate,
                                      f32_peak, timed)
    out["bn_floor"] = bn_floor_timing(torch, fused_bn, kernels, card, timed)
    out["shapes"] = sorted(shapes)
    return out


# the phases of the native gather's comparison (in train_run_phases), the
# custom ops, the AOT serve artifact, the JAX package's checkpoint format
# and the tool modules (48-54)
AOT_BATCH = 16
AOT_REQUESTS = 20
LATENCY_BATCHES = (1, 8, 16, 64)
LATENCY_REQUESTS = 20
BENCH3D_STEPS = 3
NATIVE_TIMED_BATCHES = 20


def custom_ops_phase(torch, kernels, fused_bn, card: str, seed: int) -> dict:
    """Phase 48 (``custom_ops``): ``torch.library.opcheck`` of each of the
    four ``rdt::`` ops on CUDA tensors at one flagship shape, bf16 (schema,
    fake implementation, autograd registration, AOT dispatch), and the
    host cost of the op's dispatch against the bare launcher, back to back
    at the smallest SPADE shape."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    rnd = lambda *s: torch.randn(s, generator=g, device=DEVICE)
    bf = torch.bfloat16
    zi, gamma, beta = ((3.0 + 2.0 * rnd(64, 128, 40, 48)).to(bf),
                       (0.5 * rnd(64, 128, 40, 48)).to(bf),
                       (0.5 * rnd(64, 128, 40, 48)).to(bf))
    x = rnd(*FLAGSHIP_BN_SHAPES[0][0]).to(bf)
    mean, var = fused_bn.bn_stats_plain(x)
    c = x.shape[2]
    cases = {
        "in_modulate": (torch.ops.rdt.in_modulate.default,
                        (zi.requires_grad_(), gamma.requires_grad_(),
                         beta.requires_grad_(), 1e-5)),
        "in_modulate_bwd": (torch.ops.rdt.in_modulate_bwd.default,
                            (zi.detach(), gamma.detach(),
                             rnd(64, 128, 40, 48).to(bf), 1e-5)),
        "bn_stats": (torch.ops.rdt.bn_stats.default, (x,)),
        "bn_norm": (torch.ops.rdt.bn_norm.default,
                    (x.clone().requires_grad_(), mean, var,
                     (1.0 + rnd(c)).requires_grad_(),
                     rnd(c).requires_grad_(), 1e-5))}
    for name, (op, args) in cases.items():
        t0 = time.perf_counter()
        try:
            torch.library.opcheck(op, args)
            ok, err = True, ""
        except Exception as e:               # reported, then the run ends
            ok, err = False, f"{type(e).__name__}: {e}"[:2000]
        emit({"phase": "custom_ops", "op": f"rdt::{name}", "dtype": "bf16",
              "shapes": [list(a.shape) for a in args
                         if isinstance(a, torch.Tensor)],
              "opcheck": ok, "error": err,
              "seconds": time.perf_counter() - t0})
        check(ok, f"opcheck of rdt::{name} failed: {err}")
    z1, g1, b1 = (t.detach()[:1, :, :5, :6].contiguous() for t in
                  (zi, gamma, beta))
    op_ms = time_ms(torch, lambda: torch.ops.rdt.in_modulate(
        z1, g1, b1, 1e-5), iters=200, warmup=20)
    launcher_ms = time_ms(torch, lambda: kernels.in_modulate_cuda(
        z1, g1, b1), iters=200, warmup=20)
    rec = {"phase": "custom_ops_dispatch", "card": card,
           "shape": list(z1.shape), "op_ms": op_ms,
           "launcher_ms": launcher_ms,
           "dispatch_us": (op_ms - launcher_ms) * 1e3}
    emit(rec)
    return rec


# the artifact in a fresh process that imports only the port: load it,
# time its first request and AOT_REQUESTS more, save its outputs
_AOT_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from representation_disentanglement_torch import serve_latency
from representation_disentanglement_torch.ops import kernels
from representation_disentanglement_torch.utils import aot
path, tmp, n, dev = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
arrays = {k: np.load(f"{tmp}/{k}.npy") for k in ("inputs", "mask",
                                                   "mask_img")}
torch.zeros(1, device=dev)
serve_latency._sync(dev)
kernels.reset_launch_counts()
t0 = time.perf_counter()
step, hdr = aot.load_serve_step(path)
t1 = time.perf_counter()
out = step(arrays["inputs"], arrays["mask"], arrays["mask_img"])
serve_latency._sync(dev)
t2 = time.perf_counter()
launches = kernels.launch_counts()
np.save(f"{tmp}/aot_x_hat.npy", out[0].cpu().numpy())
np.save(f"{tmp}/aot_y.npy", out[1].cpu().numpy())
lat = serve_latency._latencies(step, arrays, n, dev)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "representation_disentanglement_tpu"))
print(json.dumps(dict({"load_s": t1 - t0, "first_call_s": t2 - t1,
                       "cold_start_s": t2 - t0, "launches": launches,
                       "header": hdr, "foreign_modules": bad},
                      **serve_latency._summary(lat, arrays["inputs"].shape[1]))))
"""

# the live step's cold start in a fresh process: build the flagship model
# (the given size fields; the flagship's own on the card) from the seed and
# answer the first request
_LIVE_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from representation_disentanglement_torch import config, serve, serve_latency
from representation_disentanglement_torch.models.multimodal import build_model
tmp, seed, dev = sys.argv[1], int(sys.argv[2]), sys.argv[3]
arrays = {k: np.load(f"{tmp}/{k}.npy") for k in ("inputs", "mask",
                                                   "mask_img")}
torch.zeros(1, device=dev)
serve_latency._sync(dev)
t0 = time.perf_counter()
cfg = config.flagship()
for k, v in json.loads(sys.argv[4]).items():
    setattr(cfg, k, v)
model = build_model(cfg, device=dev,
                    generator=torch.Generator().manual_seed(seed))
serve_latency._sync(dev)
t1 = time.perf_counter()
step = serve.make_serve_step(model, cfg, source=1)
step(arrays["inputs"], arrays["mask"], arrays["mask_img"])
serve_latency._sync(dev)
t2 = time.perf_counter()
print(json.dumps({"build_s": t1 - t0, "first_call_s": t2 - t1,
                  "cold_start_s": t2 - t0}))
"""


def _child(script: str, *args, timeout: int = 300) -> dict:
    """Run ``script`` in a fresh Python process with this checkout's
    package on the path; returns the JSON of its last line."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=timeout)
    check(res.returncode == 0, f"child process failed ({res.returncode}):"
                               f"\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def serve_sample(cfg, inputs, b: int) -> dict:
    """A serve batch of ``b`` rows of ``inputs`` with contrast 0 missing
    (the mask from contrast 1, the source)."""
    x = np.ascontiguousarray(inputs[:, :b], dtype=np.float32)
    x[0] = 0.0
    mask = np.ones((b, cfg.modality_num), np.float32)
    mask[:, 0] = 0.0
    return {"inputs": x, "mask": mask,
            "mask_img": (x[1, :, :, :, 0] == 0).astype(np.float32)}


def aot_serve_phase(torch, kernels, card: str, model, cfg, inputs,
                    seed: int, tmp: str) -> dict:
    """Phase 49 (``aot_serve``): the flagship serve step exported at B = 16
    (``utils/aot.export_serve_step``), saved, and loaded in a fresh process
    that imports only the port (``_AOT_CHILD``): its output against the
    live step's (expected bit-identical: the same kernels on the same
    weights; held within the bf16 serve tolerance at worst), the
    artifact's bytes, the cold start of each (``_LIVE_CHILD`` builds the
    model and answers the first request in another fresh process), 6
    launches of K1 per request through the artifact, and its latency over
    AOT_REQUESTS requests.  Returns the launches of the artifact's first
    request and its latency row."""
    import os
    from representation_disentanglement_torch import serve
    from representation_disentanglement_torch.utils import aot
    model.eval()
    sample = serve_sample(cfg, inputs, AOT_BATCH)
    for k, v in sample.items():
        np.save(os.path.join(tmp, f"{k}.npy"), v)
    t0 = time.perf_counter()
    blob = aot.export_serve_step(model, cfg, source=1, sample=sample)
    export_s = time.perf_counter() - t0
    path = os.path.join(tmp, f"serve_B{AOT_BATCH}.rdt")
    with open(path, "wb") as f:
        f.write(blob)
    nbytes = len(blob)
    del blob
    live = serve.make_serve_step(model, cfg, source=1)
    want = [t.cpu().numpy() for t in live(sample["inputs"], sample["mask"],
                                          sample["mask_img"])]
    child = _child(_AOT_CHILD, path, tmp, AOT_REQUESTS, DEVICE)
    size = {k: getattr(cfg, k) for k in ("input_height", "input_width",
                                         "batch_size", "effective_batch")}
    cold_live = _child(_LIVE_CHILD, tmp, seed, DEVICE, json.dumps(size))
    got = [np.load(os.path.join(tmp, f"aot_{k}.npy")) for k in ("x_hat", "y")]
    identical = all(np.array_equal(a, b) for a, b in zip(got, want))
    gaps = {k: rel_l2(a, b) for k, a, b in zip(("x_hat", "y"), got, want)}
    launches = child["launches"]
    emit({"phase": "aot_serve", "card": card, "batch": AOT_BATCH,
          "artifact_bytes": nbytes, "export_s": export_s,
          "header": child["header"], "bit_identical": identical,
          "max_abs_diff": max(float(np.abs(a - b).max())
                              for a, b in zip(got, want)),
          "rel_l2": gaps, "tolerance": SERVE_REL_L2,
          "aot_load_s": child["load_s"],
          "aot_first_call_s": child["first_call_s"],
          "aot_cold_start_s": child["cold_start_s"],
          "live_build_s": cold_live["build_s"],
          "live_first_call_s": cold_live["first_call_s"],
          "live_cold_start_s": cold_live["cold_start_s"],
          "launches_first_request": launches,
          "aot_latency": {k: child[k] for k in (
              "p50_ms", "p95_ms", "p99_ms", "mean_ms", "slices_per_s")},
          "requests": AOT_REQUESTS})
    check(not child["foreign_modules"],
          f"the artifact's process imported {child['foreign_modules']}")
    check(identical or max(gaps.values()) <= SERVE_REL_L2,
          f"the artifact's output differs from the live step's: {gaps}")
    check(launches == {"in_modulate": 6, "in_modulate_bwd": 0,
                       "bn_stats": 0, "bn_norm": 0},
          f"launches of one request through the artifact {launches}; "
          "expected 6 of K1")
    os.remove(path)
    return launches, dict(
        {k: child[k] for k in ("p50_ms", "p95_ms", "p99_ms", "mean_ms",
                               "slices_per_s")},
        aot_cold_start_s=child["cold_start_s"],
        live_cold_start_s=cold_live["cold_start_s"], requests=AOT_REQUESTS)


def to_jax_flagship(sd, cfg):
    """The flagship's port state dict as the JAX ``MultimodalModel``'s
    (params, batch_stats) trees: the inverse of ``weights.from_jax_params``
    for the shared encoders, the 'loop' decoder halves and 'U+SA' (what
    ``config.flagship()`` builds), written apart from it."""
    from representation_disentanglement_torch.weights import chw_to_hwc_perm
    sd = {k: np.ascontiguousarray(v.detach().float().cpu().numpy())
          for k, v in sd.items()}
    params, stats = {}, {}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = value

    def conv(jpath, t):
        if f"{t}._routing_fn.fc.weight" in sd:              # CondConv
            out = {"experts": np.transpose(sd[f"{t}.weight"],
                                           (0, 3, 4, 2, 1)),
                   "route_kernel": sd[f"{t}._routing_fn.fc.weight"].T,
                   "route_bias": sd[f"{t}._routing_fn.fc.bias"]}
        else:
            out = {"kernel": np.transpose(sd[f"{t}.weight"], (2, 3, 1, 0))}
        if f"{t}.bias" in sd:
            out["bias"] = sd[f"{t}.bias"]
        put(params, jpath, out)

    def bn(jpath, t):
        put(params, jpath, {"scale": sd[f"{t}.weight"],
                            "bias": sd[f"{t}.bias"]})
        put(stats, jpath, {"mean": sd[f"{t}.running_mean"],
                           "var": sd[f"{t}.running_var"]})

    def linear(jpath, t, in_perm=None):
        k = sd[f"{t}.weight"].T
        put(params, jpath, {"kernel": np.ascontiguousarray(
            k if in_perm is None else k[in_perm]), "bias": sd[f"{t}.bias"]})

    def spade(jpath, t):
        for sub in ("si_layers", "gamma", "beta", "out"):
            conv(jpath + (sub,), f"{t}.{sub}")

    enc = "anatomy_encoder_enc_list.0"
    conv(("anatomy_encoder_enc", "down_1"), f"{enc}.down_1")
    for i in (2, 3, 4, 5):
        conv(("anatomy_encoder_enc", f"down_{i}", "conv"),
             f"{enc}.down_{i}.conv")
        bn(("anatomy_encoder_enc", f"down_{i}", "bn"), f"{enc}.down_{i}.bn")
    for i in (4, 3, 2, 1):
        conv(("anatomy_encoder_dec", f"up_{i}", "conv"),
             f"anatomy_encoder_dec.up_{i}.conv")
        bn(("anatomy_encoder_dec", f"up_{i}", "bn"),
           f"anatomy_encoder_dec.up_{i}.bn")
    conv(("anatomy_encoder_dec", "output", "conv"),
         "anatomy_encoder_dec.output.conv")
    me = "modality_encoder_list.0"
    for i in range(1, 6):
        conv(("modality_encoder", f"conv{i}"), f"{me}.conv{i}")
    h32, w32 = cfg.input_height // 32, cfg.input_width // 32
    linear(("modality_encoder", "fcs"), f"{me}.fcs.0",
           chw_to_hwc_perm(8 * 16, h32, w32))
    linear(("modality_encoder", "mean"), f"{me}.mean")
    linear(("modality_encoder", "log_var"), f"{me}.log_var")
    m = cfg.modality_num
    linear(("input_decoder_shared", "ZScaler_0", "zi_scaler"),
           f"input_decoder_list.{m}.zi_scaler")
    for i in (1, 2, 3):
        spade(("input_decoder_shared", f"sp{i}"),
              f"input_decoder_list.{m}.sp{i}")
    for j in range(m):
        for i in (4, 5, 6):
            spade((f"input_decoder_notshared_{j}", f"sp{i}"),
                  f"input_decoder_list.{j}.sp{i}")
        conv((f"input_decoder_notshared_{j}", "out"),
             f"input_decoder_list.{j}.out")
    od = "output_decoder"
    conv((od, "down_1"), f"{od}.down_1.0")
    for i in (2, 3, 4, 5):
        conv((od, f"down_{i}", "conv"), f"{od}.down_{i}.conv.0")
        bn((od, f"down_{i}", "bn"), f"{od}.down_{i}.conv.1")
    for i in (4, 3, 2, 1):
        conv((od, f"up_{i}", "conv"), f"{od}.up_{i}.up.1")
        bn((od, f"up_{i}", "bn"), f"{od}.up_{i}.bn")
        for sub in ("W_x", "W_g", "W_psi"):
            conv((od, f"att_{i}", sub), f"{od}.att_{i}.{sub}")
        conv((od, f"att_{i}", "W_out_conv"), f"{od}.att_{i}.W_out.0")
        bn((od, f"att_{i}", "W_out_bn"), f"{od}.att_{i}.W_out.1")
    conv((od, "output", "conv"), f"{od}.output.up.1")
    return params, stats


def msgpack_pack(obj) -> bytes:
    """A minimal msgpack encoder of the layout flax writes
    (``serialization.msgpack_serialize`` of a tree of maps with str keys,
    numbers and ndarrays, each ndarray the extension type 1 holding a
    nested msgpack (shape, dtype name, C-order bytes)): what the JAX
    package's ``save_checkpoint`` writes, for the ``jax_checkpoint``
    phase, on a machine without ``msgpack``."""
    import struct
    out = bytearray()

    def head(n, fix, fix_max, codes):
        if n <= fix_max and fix is not None:
            out.append(fix | n)
        elif n < 1 << 8 and codes[0] is not None:
            out.extend((codes[0], n))
        elif n < 1 << 16:
            out.append(codes[1])
            out.extend(n.to_bytes(2, "big"))
        else:
            out.append(codes[2])
            out.extend(n.to_bytes(4, "big"))

    def pack(o):
        if isinstance(o, dict):
            head(len(o), 0x80, 15, (None, 0xDE, 0xDF))
            for k, v in o.items():
                pack(str(k))
                pack(v)
        elif isinstance(o, (list, tuple)):
            head(len(o), 0x90, 15, (None, 0xDC, 0xDD))
            for v in o:
                pack(v)
        elif isinstance(o, str):
            b = o.encode()
            head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            out.extend(b)
        elif isinstance(o, (bytes, bytearray)):
            head(len(o), None, -1, (0xC4, 0xC5, 0xC6))
            out.extend(o)
        elif isinstance(o, bool):
            out.append(0xC3 if o else 0xC2)
        elif isinstance(o, int):
            if 0 <= o < 128:
                out.append(o)
            else:
                out.append(0xD3)
                out.extend(o.to_bytes(8, "big", signed=True))
        elif isinstance(o, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", o))
        elif isinstance(o, np.ndarray):
            inner = msgpack_pack([list(o.shape), o.dtype.name,
                                  np.ascontiguousarray(o).tobytes()])
            head(len(inner), None, -1, (0xC7, 0xC8, 0xC9))
            out.append(1)
            out.extend(inner)
        else:
            raise TypeError(f"msgpack_pack: {type(o)}")

    pack(obj)
    return bytes(out)


def jax_checkpoint_phase(torch, card: str, model, cfg, inputs, seed: int,
                         tmp: str) -> dict:
    """Phase 50 (``jax_checkpoint``): the flagship weights written as a JAX
    package checkpoint (``to_jax_flagship``, ``msgpack_pack``: the layout
    of JAX's ``save_checkpoint``, scalars as 0-d arrays, ``opt_d_state``
    {}) and as the port's ``torch.save``, each restored through
    ``main_missing._restore`` into a flagship model of other weights on the
    card: every tensor restored, the two state dicts equal, and the serve
    outputs of the two equal bit for bit."""
    import os
    from representation_disentanglement_torch import main_missing, serve
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.training import checkpoint
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    params, stats = to_jax_flagship(sd, cfg)
    f0 = np.asarray(0.5, np.float32)
    payload = {"epoch": np.asarray(3, np.int64), "monitor_metric": f0,
               "stat": {"loss": f0}, "params": params,
               "batch_stats": stats, "opt_d_state": {},
               "scheduler": {"lr": np.asarray(cfg.lr), "best": f0,
                             "num_bad_epochs": np.asarray(0, np.int64)}}
    dirs = {k: os.path.join(tmp, f"run_{k}") for k in ("torch", "jax")}
    checkpoint.save_checkpoint({"epoch": 3, "params": sd}, True,
                               dirs["torch"])
    t0 = time.perf_counter()
    blob = msgpack_pack(payload)
    os.makedirs(dirs["jax"], exist_ok=True)
    with open(os.path.join(dirs["jax"], "model_best.ckpt"), "wb") as f:
        f.write(blob)
    write_s, nbytes = time.perf_counter() - t0, len(blob)
    del blob, payload, params, stats
    other = build_model(cfg, device=DEVICE,
                        generator=torch.Generator().manual_seed(seed + 99))
    sample = serve_sample(cfg, inputs, cfg.batch_size)
    outs, sds, restored, read_s = {}, {}, {}, {}
    for fmt, d in dirs.items():
        run = copy_cfg(cfg, ckpt_path=d)
        t0 = time.perf_counter()
        ckpt, restored[fmt] = main_missing._restore(other, run,
                                                    "model_best.ckpt")
        read_s[fmt] = time.perf_counter() - t0
        check(int(ckpt["epoch"]) == 3, f"{fmt} checkpoint epoch "
                                       f"{ckpt['epoch']}")
        sds[fmt] = {k: v.detach().cpu().clone()
                    for k, v in other.state_dict().items()}
        step = serve.make_serve_step(other, cfg, source=1)
        outs[fmt] = [t.cpu() for t in step(sample["inputs"], sample["mask"],
                                           sample["mask_img"])]
        with torch.no_grad():                   # the next restore must act
            for p in other.parameters():
                p.zero_()
    same_sd = all(torch.equal(sds["torch"][k], sds["jax"][k])
                  for k in sds["torch"])
    same_out = all(torch.equal(a, b) for a, b in zip(outs["torch"],
                                                     outs["jax"]))
    emit({"phase": "jax_checkpoint", "card": card, "msgpack_bytes": nbytes,
          "write_s": write_s, "restore_s": read_s, "restored": restored,
          "state_dicts_equal": same_sd, "serve_bit_identical": same_out})
    check(all(r[0] == r[1] == len(sd) for r in restored.values()),
          f"restored {restored} of {len(sd)} tensors")
    check(same_sd and same_out, "the JAX-format checkpoint restored other "
                                "weights than the torch.save one")
    del other
    torch.cuda.empty_cache()
    return restored


def tool_phases(torch, kernels, card: str, model, cfg, inputs,
                tmp: str, aot_row: dict) -> None:
    """Phases 51-53: ``serve_latency`` live at B in LATENCY_BATCHES
    (``serve_latency``; the AOT row is ``aot_serve``'s); ``bench3d`` at
    ``main_3d``'s defaults in f32 and bf16 (``bench3d``); a ``trace`` of
    two serve steps whose Chrome trace names the ``rdt::in_modulate`` op
    and its kernel (``trace``), with ``device_memory_stats``."""
    import os
    from representation_disentanglement_torch import (
        bench3d, serve, serve_latency)
    from representation_disentanglement_torch.utils import profiling
    for b in LATENCY_BATCHES:
        row = serve_latency.profile_batch(b, LATENCY_REQUESTS, DEVICE)
        emit(dict({"phase": "serve_latency", "card": card, "mode": "live"},
                  **row))
        check(0 < row["p50_ms"] <= row["p99_ms"],
              f"serve latency at B={b}: {row}")
        torch.cuda.empty_cache()
    emit(dict({"phase": "serve_latency", "card": card, "mode": "aot",
               "batch": AOT_BATCH}, **aot_row))
    for dtype in ("float32", "bfloat16"):
        torch.cuda.reset_peak_memory_stats()
        res = bench3d.bench(VOL_HWD, 4, 3, VOL_INIT, 1, BENCH3D_STEPS, dtype,
                            DEVICE)
        emit(dict({"phase": "bench3d", "card": card,
                   "flop_vs_chip_smoke_count": res["flop_per_step"]
                   / VOL_TRAIN_FLOP}, **res))
        check(res["value"] > 0 and np.isfinite(res["step_ms"]),
              f"bench3d {dtype}: {res}")
        torch.cuda.empty_cache()
    model.eval()
    step = serve.make_serve_step(model, cfg, source=1)
    sample = serve_sample(cfg, inputs, cfg.batch_size)
    step(sample["inputs"], sample["mask"], sample["mask_img"])
    logdir = os.path.join(tmp, "trace")
    with profiling.trace(logdir) as prof:
        for _ in range(2):
            step(sample["inputs"], sample["mask"], sample["mask_img"])
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    op_events = sum(1 for e in events
                    if e.get("name", "").startswith("rdt::in_modulate"))
    kernel_names = sorted(n for n in names if "in_modulate" in n
                          and not n.startswith("rdt::"))
    dev_us = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if "in_modulate" in ev.key:
            dev_us[ev.key] = float(t)
    emit({"phase": "trace", "card": card, "steps": 2,
          "trace_bytes": os.path.getsize(os.path.join(logdir,
                                                      "trace.json")),
          "events": len(events), "rdt_in_modulate_events": op_events,
          "kernel_names": kernel_names, "device_us": dev_us,
          "device_memory_stats": profiling.device_memory_stats()})
    check(op_events >= 12, f"the trace of two serve steps holds "
                           f"{op_events} rdt::in_modulate events; expected "
                           "12 calls")


# ---------------------------------------------------------------------------
# 54-58. multi-GPU: the data-parallel 2D step and run, the depth-sharded and
# composed 3D step, channel TP (parallel/), one process per card over NCCL
# ---------------------------------------------------------------------------

PAR_TIMED_STEPS = 3
PAR_LOSS_REL = 2e-3          # the bf16 DP step against the unsharded one
PAR_PARAM_ATOL = 5e-4        # 2 lr: the first Adam step is lr * sign(g)
PAR_VOL_LOSS_REL = 1e-4      # the f32 sharded 3D step (cuDNN, one-pass GN)
PAR_VOL_PARAM_ATOL = 3e-4    # lr 1e-4: a flipped sign moves 2e-4
PAR_VOL_OUT_ATOL = 1e-3      # the sharded and the unsharded forward
PAR_RUN_CUTS = ("train_run's 8 phantom subjects (5 train sharded over the "
                "cards, 1 val, 2 test), 32 slices each; one epoch, then a "
                "resume for a second")


def state_gap(torch, a: dict, b: dict) -> float:
    """The largest absolute gap between two state dicts' tensors."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in b)


def rank_peaks(torch, dist) -> list:
    """Every rank's peak allocated memory (GB) since the last reset."""
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 1e9)
    return peaks


def parallel_rank(seed: int, tmp: str, card: str, store=None,
                  device=None) -> dict:
    """The multi-GPU phases on every rank of the process group (rank r on
    cuda:r); rank 0 compares with the unsharded step on its card, emits the
    records and returns the launch counts of the DP paths.  Each rank's
    phantoms are ``store`` or made from ``seed``, its fold txts under its
    own directory of ``tmp``; the run directory is shared."""
    import os
    import torch
    import torch.distributed as dist
    from representation_disentanglement_torch import config, main_missing
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.models.unet3d import (
        build_nvnet3d)
    from representation_disentanglement_torch.ops import kernels
    from representation_disentanglement_torch.parallel import (
        halo, mesh as pm, tp)
    from representation_disentanglement_torch.training import (
        optim, train, train3d)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    lead = rank == 0
    axis = pm.whole_axis()
    say = emit if lead else (lambda rec: None)
    out = {"launches": {}}

    # 54. dp_train: the flagship step on B/N rows of each rank
    cfg = config.flagship()
    batch = train_batch(np.random.default_rng(seed), cfg)
    pairs = train.draw_pairs(np.random.default_rng(seed), cfg.modality_num,
                             1)
    local = pm.shard_batch(batch, axis, stacked=True)
    for fuse in (False, True):
        c = copy_cfg(cfg, fuse_bn=fuse)
        model = build_model(c, device=device, generator=torch.Generator()
                            .manual_seed(seed))
        sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        step = train.make_train_step(model, c, optim.make_optimizer(
            model.parameters(), c), mesh=axis)
        gen = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        got = train.metrics_to_dict(step(local, gen, pairs))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        peaks = rank_peaks(torch, dist)
        rec = {"phase": "dp_train_fused_bn" if fuse else "dp_train",
               "card": card, "world": world, "batch": cfg.batch_size,
               "rows_per_rank": cfg.batch_size // world,
               "compute_dtype": cfg.compute_dtype, "launches": launches,
               "peak_mem_gb_per_rank": peaks, "loss": got["all"]}
        if lead:
            ref = build_model(c, device=device)
            ref.load_state_dict(sd0)
            ref_step = train.make_train_step(ref, c, optim.make_optimizer(
                ref.parameters(), c))
            want = train.metrics_to_dict(ref_step(
                batch, torch.Generator(device=device).manual_seed(seed),
                pairs))
            rel = abs(got["all"] - want["all"]) / abs(want["all"])
            gap = state_gap(torch, model.state_dict(), ref.state_dict())
            rec.update(unsharded_loss=want["all"], loss_rel=rel,
                       loss_rel_tolerance=PAR_LOSS_REL, state_abs_gap=gap,
                       state_atol=PAR_PARAM_ATOL)
            check(rel <= PAR_LOSS_REL, f"{rec['phase']}: loss {rel:.2e} "
                  "from the unsharded step")
            check(gap <= PAR_PARAM_ATOL, f"{rec['phase']}: weights "
                  f"{gap:.2e} from the unsharded step")
            del ref, ref_step
        check(launches["in_modulate"] > 0 and launches["in_modulate_bwd"]
              > 0, "the DP step launched no SPADE kernel")
        check((launches["bn_stats"] > 0) == fuse
              and (launches["bn_norm"] > 0) == fuse,
              "the DP step's BatchNorm kernels do not follow fuse_bn")
        ms = step_ms(torch, lambda: step(local, gen, pairs), PAR_TIMED_STEPS)
        rec.update(step_ms=float(np.median(ms)), step_ms_all=ms,
                   slices_per_s=cfg.batch_size / float(np.median(ms)) * 1e3)
        say(rec)
        out["launches"][rec["phase"]] = launches
        del model, step
        torch.cuda.empty_cache()

    # 55. dp_run: main_missing.run on the mesh over the sharded cache
    data_path = os.path.join(tmp, f"data{rank}")
    if store is None:
        store = train_run_data(seed, cfg, data_path)
    else:
        write_run_folds(cfg, data_path)
    rc = copy_cfg(cfg, seed=seed, data_path=data_path, epochs=1,
                  epoch_chunk_steps=RUN_CHUNK, mesh_shape={"data": world},
                  log_every=0)
    root = os.path.join(tmp, "ckpt")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    first = main_missing.run(rc, ckpt_root=root, store=store, device=device)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peaks = rank_peaks(torch, dist)
    label = os.path.basename(first["ckpt_path"])
    res = main_missing.run(copy_cfg(rc, epochs=2, continue_train=True,
                                    load_yaml=False, ckpt_timelabel=label,
                                    ckpt_name="epoch000.ckpt"),
                           ckpt_root=root, store=store, device=device)
    if lead:
        rows = read_stat_csv(os.path.join(first["ckpt_path"], "stat.csv"))
        ep = first["epochs"][0]
        check(first["mesh"] == world and first["loader"] == "device",
              f"dp_run ran on {first['mesh']} ranks over {first['loader']}")
        check([i for i, _ in rows] == ["epoch[ 0]", "val", "epoch[ 1]",
                                       "val"],
              f"dp_run's stat.csv rows {[i for i, _ in rows]}")
        check(res["restored"][0] == res["restored"][1]
              and res["optimizer_loaded"], "dp_run's resume restored "
              f"{res['restored']}, optimizer {res['optimizer_loaded']}")
        check(all(np.isfinite(r["train"]["all"]) for r in
                  first["epochs"] + res["epochs"]), "dp_run: non-finite")
        check(launches["in_modulate"] > 0 and launches["in_modulate_bwd"]
              > 0, "dp_run launched no SPADE kernel")
    say({"phase": "dp_run", "card": card, "world": world,
         "cuts": PAR_RUN_CUTS, "run_dir": label,
         "cache_bytes": first["cache_bytes"],
         "cache_bytes_per_card": first["cache_bytes_per_card"],
         "steps": first["epochs"][0]["steps"],
         "train_s": first["epochs"][0]["train_s"],
         "slices_per_s": first["epochs"][0]["slices_per_s"],
         "val_s": first["epochs"][0].get("val_s"),
         "resume": {"start_epoch": res["start_epoch"],
                    "restored": res["restored"],
                    "optimizer_loaded": res["optimizer_loaded"],
                    "train_s": res["epochs"][0]["train_s"]},
         "launches": launches, "peak_mem_gb_per_rank": peaks})
    out["launches"]["dp_run"] = launches
    del store

    # 56-57. depth3d (and depth3d_composed at 4 or more cards): one sharded
    # NVNet3D step at main_3d's defaults and the sharded inference
    rs = np.random.default_rng(seed)
    H, W, D = VOL_HWD
    vols = torch.tensor(rs.normal(size=(2, 4, H, W, D)), dtype=torch.float32,
                        device=device)
    tgts = torch.tensor(rs.integers(0, 4, (2, 1, H, W, D)),
                        dtype=torch.float32, device=device)
    meshes = [("depth3d", 1, world)]
    if world >= 4 and world % 2 == 0:
        meshes.append(("depth3d_composed", 2, world // 2))
    else:
        say({"phase": "depth3d_composed", "card": card, "world": world,
             "skipped": "needs 4 or more cards (2 x N/2)"})
    for phase, na, nd in meshes:
        vm = halo.make_depth_mesh(nd) if na == 1 \
            else halo.make_volume_mesh(na, nd)
        vb = {"inputs": vols[:na], "targets": tgts[:na]}
        model = build_nvnet3d(VOL_HWD, in_channels=4, init_channels=VOL_INIT,
                              device=device, generator=torch.Generator()
                              .manual_seed(seed))
        sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        infer = halo.sharded_nvnet_infer_fn(
            model, halo.VolumeMesh(vm.depth, None, vm.depth))
        sharded_out = infer(vb["inputs"])
        opt = train3d.create_state_3d(model, lr=VOL_LR)
        step = train3d.make_sharded_train_step_3d(model, opt, vm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = {k: float(v) for k, v in step(vb).items()}
        torch.cuda.synchronize()
        peaks = rank_peaks(torch, dist)
        rec = {"phase": phase, "card": card, "world": world,
               "mesh": [na, nd], "hwd": list(VOL_HWD), "init": VOL_INIT,
               "batch": na, "dtype": "f32", "loss": got["loss"],
               "peak_mem_gb_per_rank": peaks}
        if lead:
            ref = build_nvnet3d(VOL_HWD, in_channels=4,
                                init_channels=VOL_INIT, device=device)
            ref.load_state_dict(sd0)
            ref.eval()
            with torch.no_grad():
                want_out = ref(vb["inputs"])
            want = {k: float(v) for k, v in train3d.make_train_step_3d(
                ref, train3d.create_state_3d(ref, lr=VOL_LR))(vb).items()}
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            gap = state_gap(torch, model.state_dict(), ref.state_dict())
            out_gap = max(float((a - b).abs().max())
                          for a, b in zip(sharded_out, want_out))
            rec.update(unsharded_loss=want["loss"], loss_rel=rel,
                       loss_rel_tolerance=PAR_VOL_LOSS_REL,
                       state_abs_gap=gap, state_atol=PAR_VOL_PARAM_ATOL,
                       infer_abs_gap=out_gap,
                       infer_atol=PAR_VOL_OUT_ATOL)
            check(rel <= PAR_VOL_LOSS_REL, f"{phase}: loss {rel:.2e} from "
                  "the unsharded step")
            check(gap <= PAR_VOL_PARAM_ATOL, f"{phase}: weights {gap:.2e} "
                  "from the unsharded step")
            check(out_gap <= PAR_VOL_OUT_ATOL, f"{phase}: sharded inference "
                  f"{out_gap:.2e} from the unsharded forward")
            del ref
        ms = step_ms(torch, lambda: step(vb), PAR_TIMED_STEPS)
        ims = step_ms(torch, lambda: infer(vb["inputs"]), PAR_TIMED_STEPS)
        rec.update(step_ms=float(np.median(ms)), step_ms_all=ms,
                   infer_ms=float(np.median(ims)))
        say(rec)
        del model, opt, step, infer, sharded_out
        torch.cuda.empty_cache()

    # 58. tp3d: the channel-sharded NVNet3D forward at main_3d's defaults
    model = build_nvnet3d(VOL_HWD, in_channels=4, init_channels=VOL_INIT,
                          device=device, generator=torch.Generator()
                          .manual_seed(seed))
    x = vols[:1]
    with torch.no_grad():
        want_out = model(x)
        fwd = lambda: model(x)
        with tp.channel_parallel(axis):
            got_out = model(x)
            tp_ms = step_ms(torch, fwd, PAR_TIMED_STEPS)
        plain_ms = step_ms(torch, fwd, PAR_TIMED_STEPS)
    gap = max(float((a - b).abs().max()) for a, b in zip(got_out, want_out))
    check(gap <= PAR_VOL_OUT_ATOL, f"tp3d: {gap:.2e} from the forward")
    say({"phase": "tp3d", "card": card, "world": world,
         "hwd": list(VOL_HWD), "init": VOL_INIT, "abs_gap": gap,
         "atol": PAR_VOL_OUT_ATOL, "forward_ms": float(np.median(tp_ms)),
         "unsharded_forward_ms": float(np.median(plain_ms))})
    return out


def parallel_phases(torch, card: str, seed: int, store=None) -> dict:
    """Phases 54-58 at world size ``torch.cuda.device_count()`` over NCCL:
    one card in a process group of one, in this process (``store``, the
    run's volumes, reused); more cards in one process each."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from representation_disentanglement_torch.parallel import mesh as pm
    world = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="rdt_parallel_")
    t0 = time.perf_counter()
    try:
        if world == 1:
            dist.init_process_group(
                "nccl", init_method=f"tcp://localhost:{pm.free_port()}",
                world_size=1, rank=0)
            try:
                out = parallel_rank(seed, tmp, card, store,
                                    device=torch.device("cuda", 0))
            finally:
                dist.destroy_process_group()
        else:
            out = pm.spawn(world, parallel_rank, seed, tmp, card,
                           device="cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "parallel_total", "card": card, "world": world,
          "seconds": time.perf_counter() - t0})
    return out["launches"]


# ---------------------------------------------------------------------------
# 59. the benchmark entry point (representation_disentanglement_torch.bench)
# ---------------------------------------------------------------------------

BENCH_STEPS = 5
# XLA's cost analysis of the JAX package's flagship train step
# (BENCH_r05.json, flops_per_step): a count of work, no speed; the port
# counts every kernel tap, padding included, and no elementwise op
XLA_TRAIN_STEP_FLOP = 4655693168640.0
BENCH_FLOP_BAND = (0.5, 1.5)
BENCH_RATES = ("value", "infer_slices_per_sec", "val_slices_per_sec",
               "serving_slices_per_sec", "tflops_per_sec")
BENCH_NULL = ("vs_baseline", "bytes_per_step", "hbm_gbps",
              "baseline_train_slices_per_sec")


def bench_launches_expected(fuse_bn: bool) -> dict:
    """Launches per call of each bench measurement at the flagship (M = 4,
    one microbatch): 3 + 3 M of each SPADE kernel per train step, 16 of
    each BatchNorm kernel with ``fuse_bn``; 3 + 3 M forward launches per
    infer and val call, 6 per serve call."""
    bn = BN_CALLS if fuse_bn else 0
    none = {"in_modulate_bwd": 0, "bn_stats": 0, "bn_norm": 0}
    return {"train": {"in_modulate": 15, "in_modulate_bwd": 15,
                      "bn_stats": bn, "bn_norm": bn},
            "infer": dict(none, in_modulate=15),
            "serve": dict(none, in_modulate=6),
            "val": dict(none, in_modulate=15)}


def bench_phase(card: str) -> dict:
    """Phase 59: the bench at the flagship defaults and with ``--fuse-bn``,
    each in a child process; returns the launches of each of its
    measurements (per call times calls) by path."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    paths = {}
    for fuse_bn in (False, True):
        argv = ["--steps", str(BENCH_STEPS)] + (["--fuse-bn"] if fuse_bn
                                                 else [])
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "representation_disentanglement_torch."
             "bench", *argv], cwd=root, env=env, capture_output=True,
            text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(res.returncode == 0, f"bench {argv} failed ({res.returncode})"
                                   f":\n{res.stderr[-4000:]}")
        lines = res.stdout.strip().splitlines()
        out, launch = json.loads(lines[-1]), json.loads(lines[-2])
        ratio = out["flops_per_step"] / XLA_TRAIN_STEP_FLOP
        emit({"phase": "bench", "card": card, "argv": argv,
              "seconds": seconds, "result": out, **launch,
              "flops_vs_xla_count": ratio})
        for k in BENCH_RATES:
            check(np.isfinite(out[k]) and out[k] > 0,
                  f"bench {argv}: {k} = {out[k]}")
        check(out["mfu"] is not None and 0 < out["mfu"] <= 1,
              f"bench {argv}: mfu = {out['mfu']}")
        check(BENCH_FLOP_BAND[0] <= ratio <= BENCH_FLOP_BAND[1],
              f"bench {argv}: {out['flops_per_step']} FLOP per step, "
              f"{ratio} of XLA's count")
        check(all(out[k] is None for k in BENCH_NULL),
              f"bench {argv}: a field without a counterpart is set")
        check(out["device"] == card, f"bench {argv}: device "
                                     f"{out['device']!r}, not {card!r}")
        want = bench_launches_expected(fuse_bn)
        check(launch["launches_per_call"] == want,
              f"bench {argv}: launches per call "
              f"{launch['launches_per_call']}; expected {want}")
        tag = "bench_fused_bn_" if fuse_bn else "bench_"
        for m, per_call in launch["launches_per_call"].items():
            paths[tag + m] = {k: int(v * launch["calls"][m])
                              for k, v in per_call.items()}
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bn-timing", action="store_true",
                    help="only build the kernels and run bn_kernel_timing "
                         "at the flagship's and the discriminator's "
                         "BatchNorm shapes, then exit (no result line)")
    ap.add_argument("--options", action="store_true",
                    help="only build the kernels and run the 2D model "
                         "options' phases (37-44), then exit (no result "
                         "line)")
    ap.add_argument("--legacy", action="store_true",
                    help="only build the kernels and run the phases of "
                         "the modules beside MultimodalModel (45-47), "
                         "then exit (no result line)")
    ap.add_argument("--parallel", action="store_true",
                    help="only build the kernels and run the multi-GPU "
                         "phases (54-58) on every visible card, then exit "
                         "(no result line)")
    ap.add_argument("--root", default=None,
                    help="with --bn-timing: import the port's package from "
                         "this checkout (e.g. an unpacked earlier commit) "
                         "instead of this script's")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if args.root is not None:
        if not args.bn_timing:
            ap.error("--root needs --bn-timing")
        sys.path.insert(0, args.root)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from representation_disentanglement_torch import config, serve
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.ops import fused_bn, kernels
    from representation_disentanglement_torch.utils.profiling import (
        dense_peak)

    # 1. the card
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mem_rate = _lookup(_MEM_RATE, kind, 3.35e12)
    f32_peak = dense_peak(kind, "float32")
    check(f32_peak is not None, f"no published f32 peak of {kind!r} in "
                                "utils/profiling.DENSE_PEAKS")
    emit({"phase": "card", "nvidia_smi": card, "device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "mem_rate_bytes_per_s": mem_rate, "f32_peak": f32_peak})

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
    if args.options:
        options_phases(torch, kernels, fused_bn, card, args.seed,
                       np.random.default_rng(args.seed), mem_rate, f32_peak)
        return 0
    if args.legacy:
        legacy_phases(torch, kernels, fused_bn, card, args.seed, mem_rate,
                      f32_peak)
        return 0
    if args.parallel:
        parallel_phases(torch, card, args.seed)
        return 0
    if args.bn_timing:
        shapes = FLAGSHIP_BN_SHAPES + [(s, 0, 0) for s in D_BN_SHAPES]
        bn_rows = bn_kernel_timing(torch, fused_bn, card, args.seed,
                                   mem_rate, f32_peak, shapes)
        emit({"phase": "bn_timing_totals", "card": card,
              "package": fused_bn.__file__,
              "per_step": {k: bn_totals(bn_rows, k, "per_step")
                           for k in bn_rows},
              "per_first_of_epoch_step": {
                  k: bn_totals(bn_rows, k, "per_first_step")
                  for k in bn_rows}})
        return 0

    # 59. the benchmark entry point in child processes, while this process
    # holds little of the card
    bench_launches = bench_phase(card)

    # 48. the four kernels as torch custom ops: opcheck on the card
    custom_ops_phase(torch, kernels, fused_bn, card, args.seed)

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
    calls = bn_calls(torch, T, model, cfg, batch, pairs[0])
    regular = [c for c in calls if not c[0].startswith("output_decoder")]
    check((len(calls), len(regular)) == (BN_CALLS_FIRST, BN_CALLS),
          f"{len(calls)} BatchNorm calls in a first-of-epoch step, "
          f"{len(regular)} in a later one; expected {BN_CALLS_FIRST} and "
          f"{BN_CALLS}")
    shape_counts = sorted(
        (tuple(s), sum(1 for c in regular if tuple(c[1:]) == tuple(s)),
         sum(1 for c in calls if tuple(c[1:]) == tuple(s)))
        for s in dict.fromkeys(tuple(c[1:]) for c in calls))
    check(shape_counts == sorted(FLAGSHIP_BN_SHAPES),
          f"the flagship step's BatchNorm shapes {shape_counts} are not "
          "FLAGSHIP_BN_SHAPES")
    sites = list(dict.fromkeys(calls))          # the latent cycle repeats
    bn_err = {"mean_rel": 0.0, "var_rel": 0.0, "stats_abs": 0.0,
              "y_abs": 0.0}
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cases = [(name, shape, dt, "f32", 0, args.seed + k)
             for k, (name, *shape) in enumerate(sites)
             for dt in ("bf16", "f32")]
    cases += [("edge", list(shape), dt, pdt, off, args.seed + 50 + k)
              for k, (shape, dt, pdt, off) in enumerate(BN_EDGE_CASES)]
    for name, shape, dt, pdt, off, seed in cases:
        res = bn_check(torch, fused_bn, shape, dtypes[dt], seed,
                       dtypes[pdt], off)
        bn_err["mean_rel"] = max(bn_err["mean_rel"],
                                 res["mean_err_rel_mean_abs_x"])
        bn_err["var_rel"] = max(bn_err["var_rel"], res["var_err_rel_mean_x2"])
        bn_err["stats_abs"] = max(bn_err["stats_abs"],
                                  res["stats_max_abs_err"])
        bn_err["y_abs"] = max(bn_err["y_abs"], res["y_max_abs_err"])
        emit(dict({"phase": "bn_kernel_check", "site": name, "shape": shape,
                   "dtype": dt, "param_dtype": pdt, "x_offset_values": off,
                   "tolerance": f"mean {BN_STATS_REL} x mean|x|, var "
                   f"{BN_STATS_REL} x mean(x^2); y 2^"
                   f"{int(np.log2(BN_NORM_REL))} x the magnitudes of "
                   f"its terms + {BF16_ULPS} bf16 ulps of a bf16 y; a "
                   "second K6 launch bit-identical"}, **res))
        check(res["ok"], f"BatchNorm kernels disagree with plain (or with "
                         f"themselves) at {name} {shape} {dt}/{pdt} offset "
                         f"{off}")

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
    bn_rows = bn_kernel_timing(torch, fused_bn, card, args.seed, mem_rate,
                               f32_peak, FLAGSHIP_BN_SHAPES)
    floor_rows = bn_floor_timing(torch, fused_bn, kernels, card,
                                 FLAGSHIP_BN_SHAPES)

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

    # 37-44. the 2D model options: SPADEFull with per-modality encoders,
    # mod_enc_s, 'U+SSA+CA' and fuse_bn; the vmap halves with 'U+SA+CA'
    # and the VGG paths; the pre-CondConv set with 'U'
    opt = options_phases(torch, kernels, fused_bn, card, args.seed, rng,
                         mem_rate, f32_peak)
    max_err = max(max_err, opt["max_err"])
    max_err_bwd = max(max_err_bwd, opt["max_err_bwd"])

    # 45-47. the modules beside MultimodalModel at full width, every
    # BatchNorm through K6/K7
    leg = legacy_phases(torch, kernels, fused_bn, card, args.seed, mem_rate,
                        f32_peak)

    # 29-36. the whole-volume 3D path on the run's phantoms
    vol_launches = volume3d_phases(torch, kernels, card, args.seed, store,
                                   f32_peak)

    # 54-58. multi-GPU over NCCL at world size = the cards visible
    par_launches = parallel_phases(torch, card, args.seed, store)
    del store

    # 49-53. the AOT serve artifact, the JAX package's checkpoint format,
    # serve latency, bench3d and a trace
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="rdt_slice11_")
    try:
        aot_launches, aot_row = aot_serve_phase(
            torch, kernels, card, model, cfg, inputs, args.seed, tmp)
        jax_checkpoint_phase(torch, card, model, cfg, inputs, args.seed,
                             tmp)
        tool_phases(torch, kernels, card, model, cfg, inputs, tmp, aot_row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "total", "card": card,
          "seconds": time.perf_counter() - t_start})

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
             **opt["launches"], **leg["launches"], **vol_launches,
             "aot_serve": aot_launches, **par_launches, **bench_launches}
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
                     "the replay of a CUDA graph of 20 calls, cold_ms one "
                     "call after a 256 MiB write between CUDA events, "
                     "cold_device_ms a CUDA graph of 20 (write, call) "
                     "pairs less one of the 20 writes; floor_* an empty "
                     "kernel at the same grid through the same launch",
        "bound_by": "operations" if any(
            r["bound_by"] == "operations"
            for r in bn_rows[kname].values()) else "bytes",
        "first_of_epoch_step": dict(
            bn_totals(bn_rows, kname, "per_first_step"),
            **bn_totals(floor_rows, kname, "per_first_step",
                        BN_FLOOR_TIMED)),
        "options_full_g1_per_step": dict(
            bn_totals(opt["bn_g1_rows"], kname, "per_step"),
            **bn_totals(opt["bn_g1_floor"], kname, "per_step",
                        BN_FLOOR_TIMED)),
        "legacy_shapes": len(leg["shapes"]),
        "legacy_one_launch_per_shape": dict(
            bn_totals(leg["bn_rows"], kname, "per_step"),
            **bn_totals(leg["bn_floor"], kname, "per_step",
                        BN_FLOOR_TIMED))},
        **bn_totals(bn_rows, kname, "per_step"),
        **bn_totals(floor_rows, kname, "per_step", BN_FLOOR_TIMED))
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
                                     adv["d_bn_err"]["stats_abs"],
                                     opt["bn_err"]["stats_abs"],
                                     leg["bn_err"]["stats_abs"]),
                 "torch.var_mean over (B, H, W), biased"),
        bn_entry("bn_norm", 69, max(bn_err["y_abs"],
                                    adv["d_bn_err"]["y_abs"],
                                    opt["bn_err"]["y_abs"],
                                    leg["bn_err"]["y_abs"]),
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
