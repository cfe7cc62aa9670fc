"""Normalization primitives on NCHW tensors, with the JAX package's numerics.

``instance_norm`` is the parameter-free InstanceNorm of the SPADE blocks:
f32 statistics with a two-pass variance, the result cast back to the input
dtype.  ``batch_norm_apply`` folds BatchNorm's statistics and affine into
one scale and shift, built in f32 and cast to the activation dtype, and
applies them with one rounding (``addcmul``), as XLA fuses JAX's
``x * w + b`` into one multiply-add: rounding the product first loses the
low bits of outputs near zero (where x * w is close to -b), which moves
ReLU kinks and, in f32, a gradient by up to 2e-3 of its largest entry
(ResNet18 at 64x64, tests/test_torch_resnet_danet.py; JAX's own is within
2.4e-5 of an f64 evaluation).

BatchNorm in train mode (models/layers.py) takes its statistics from
``batch_stats``: f32 mean and the *one-pass* biased variance
E[x^2] - E[x]^2, as the JAX package computes them (not ``F.batch_norm``,
whose estimator and single EMA update differ).  A shared BN layer called on
G groups receives G ordered running-stat updates; ``sequential_ema`` folds
them into one in closed form.
"""

from __future__ import annotations

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) standardization over the last two dims."""
    x32 = x.float()
    mean = x32.mean(dim=(-2, -1), keepdim=True)
    var = (x32 - mean).square().mean(dim=(-2, -1), keepdim=True)
    return ((x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype)


def batch_norm_apply(x: torch.Tensor, mean, var, scale, bias,
                     eps: float = 1e-5) -> torch.Tensor:
    """Normalize the channel axis (third from last) of x with the given
    statistics and affine.  x: [N, C, H, W] with mean, var [C]; or grouped
    x: [G, B, C, H, W] with per-group mean, var [G, 1, C].  scale, bias:
    [C]."""
    inv = torch.reciprocal(torch.sqrt(var.float() + eps))
    w = (scale * inv).to(x.dtype)
    b = (bias - mean * scale * inv).to(x.dtype)
    return torch.addcmul(b[..., None, None], x, w[..., None, None])


def batch_stats(x: torch.Tensor, dims, axis=None) -> tuple:
    """(mean, biased var) of x over ``dims`` in f32, one pass:
    var = E[x^2] - E[x]^2 (JAX ops/norm.py::batch_stats).  With a data
    ``axis`` (parallel/mesh.py; every rank's x of one shape) E[x] and
    E[x^2] are the means over the ranks' x, differentiably: the statistics
    of the global batch."""
    x32 = x.float()
    mean = x32.mean(dim=dims)
    msq = x32.square().mean(dim=dims)
    if axis is not None:
        from representation_disentanglement_torch.parallel.mesh import (
            all_reduce_mean)
        both = all_reduce_mean(torch.stack([mean, msq]), axis)
        mean, msq = both[0], both[1]
    return mean, msq - mean.square()


def sequential_ema(running: torch.Tensor, per_call_stats: torch.Tensor,
                   momentum: float = 0.1) -> torch.Tensor:
    """Fold M ordered EMA updates r <- (1-m) r + m stat_k, k = 0..M-1, into
    one: r' = (1-m)^M r + m sum_k (1-m)^(M-1-k) stat_k.

    per_call_stats: [M, C] in call order; returns f32 [C]."""
    m = momentum
    calls = per_call_stats.shape[0]
    decay = (1.0 - m) ** calls
    powers = torch.arange(calls - 1, -1, -1, dtype=torch.float32,
                          device=per_call_stats.device)
    weights = m * torch.pow(1.0 - m, powers)
    contrib = torch.tensordot(weights, per_call_stats.float(), dims=1)
    return decay * running.float() + contrib
