"""Pooling over the last two dims of [..., H, W] (JAX ops/pool.py): VALID
windows, the stride equal to the kernel unless given."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _flat4(x: torch.Tensor):
    lead = x.shape[:-2]
    return x.reshape((-1, 1) + x.shape[-2:]), lead


def max_pool(x: torch.Tensor, kernel, stride=None) -> torch.Tensor:
    """torch F.max_pool2d over [..., H, W]."""
    x4, lead = _flat4(x)
    y = F.max_pool2d(x4, kernel, stride if stride is not None else kernel)
    return y.reshape(lead + y.shape[-2:])


def avg_pool(x: torch.Tensor, kernel, stride=None) -> torch.Tensor:
    """torch F.avg_pool2d over [..., H, W], summed in f32, full-window
    divisor, cast back to x's dtype."""
    x4, lead = _flat4(x.float())
    y = F.avg_pool2d(x4, kernel, stride if stride is not None else kernel)
    return y.reshape(lead + y.shape[-2:]).to(x.dtype)
