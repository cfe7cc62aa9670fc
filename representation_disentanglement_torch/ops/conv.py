"""Convolution primitives on NCHW tensors: plain conv and CondConv as
kernel-space mixing.

In the active model every CondConv routes on ``inputs_type = 1+i``, a
scalar constant across the batch of modality i (src/model.py:3138).  The
routing weights are then the same for every sample of a modality, and
CondConv is a plain conv whose kernel is a per-modality mixture of the
expert banks, ``W(i) = sum_e sigmoid(fc(1+i))_e * W_e``: one small
contraction per modality and no extra conv work.

Activations fold the modality (group) axis into the batch: [G*B, C, H, W],
group-major.  Weights stay f32 and are cast to the activation dtype at use.

A CondConv routed per sample (the z-conditioned generator routes on each
sample's z) mixes one kernel per sample; ``percase_conv2d`` then runs the
batch as one convolution of B feature groups, ``F.conv2d(groups=B)``: the
counterpart of JAX's ``jax.vmap`` over a conv (JAX ops/conv.py:101-111).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride=1,
           padding=0, dilation=1) -> torch.Tensor:
    """x: [N, Ci, H, W], w: [Co, Ci, kh, kw], b: [Co] or None."""
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation)


def cond_route(type_value: torch.Tensor, fc_w: torch.Tensor,
               fc_b: torch.Tensor) -> torch.Tensor:
    """Routing weights sigmoid(fc(type)) in f32: [..., emb] -> [..., E].
    ``fc_w`` is the torch Linear weight [E, emb]."""
    return torch.sigmoid(type_value.float() @ fc_w.float().t() + fc_b.float())


def mix_experts(route: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """route [G, E] x experts [E, Co, Ci, kh, kw] -> [G, Co, Ci, kh, kw],
    mixed in f32."""
    return torch.einsum("ge,eoihw->goihw", route.float(), experts.float())


def modality_conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride=1,
                    padding=0) -> torch.Tensor:
    """Conv with a distinct kernel per group of the folded batch.

    x: [G*B, Ci, H, W] (group-major), w: [G, Co, Ci, kh, kw], b: [Co] or
    None -> [G*B, Co, H', W'].  One dense conv per group."""
    groups = w.shape[0]
    xs = x.chunk(groups, dim=0)
    return torch.cat([conv2d(xg, wg, b, stride, padding)
                      for xg, wg in zip(xs, w)], dim=0)


def percase_conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride=1,
                   padding=0) -> torch.Tensor:
    """Conv with a distinct kernel per sample, as one grouped conv.

    x: [B, Ci, H, W], w: [B, Co, Ci, kh, kw] (cast to x's dtype), b: [Co],
    [B, Co] or None -> [B, Co, H', W']."""
    n, ci = x.shape[:2]
    co = w.shape[1]
    y = F.conv2d(x.reshape((1, n * ci) + x.shape[2:]),
                 w.to(x.dtype).reshape((n * co,) + w.shape[2:]),
                 stride=stride, padding=padding, groups=n)
    y = y.reshape((n, co) + y.shape[2:])
    if b is not None:
        b = b.to(y.dtype)
        y = y + (b[:, :, None, None] if b.dim() == 2 else b[:, None, None])
    return y
