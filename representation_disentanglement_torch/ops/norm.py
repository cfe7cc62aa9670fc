"""Normalization primitives on NCHW tensors, with the JAX package's numerics.

``instance_norm`` is the parameter-free InstanceNorm of the SPADE blocks:
f32 statistics with a two-pass variance, the result cast back to the input
dtype.  ``batch_norm_apply`` folds BatchNorm's statistics and affine into
one scale and shift, built in f32 and cast to the activation dtype.
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
    """x: [N, C, H, W]; mean, var, scale, bias: [C]."""
    inv = torch.reciprocal(torch.sqrt(var.float() + eps))
    w = (scale * inv).to(x.dtype)
    b = (bias - mean * scale * inv).to(x.dtype)
    return x * w[:, None, None] + b[:, None, None]
