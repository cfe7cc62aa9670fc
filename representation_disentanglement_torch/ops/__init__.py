"""Tensor ops of the port (NCHW), the counterparts of the JAX package's
``ops/``."""

from representation_disentanglement_torch.ops.activations import (
    apply_act, resolve_block_act)
from representation_disentanglement_torch.ops.conv import (
    cond_route, conv2d, mix_experts, modality_conv2d, percase_conv2d)
from representation_disentanglement_torch.ops.norm import (
    batch_norm_apply, batch_stats, instance_norm, sequential_ema)
from representation_disentanglement_torch.ops.pool import avg_pool, max_pool
from representation_disentanglement_torch.ops.resize import bilinear_resize

__all__ = ["apply_act", "resolve_block_act", "cond_route", "conv2d",
           "mix_experts", "modality_conv2d", "percase_conv2d",
           "batch_norm_apply",
           "batch_stats", "instance_norm", "sequential_ema", "avg_pool",
           "max_pool", "bilinear_resize"]
