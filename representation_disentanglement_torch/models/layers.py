"""Core modules: torch-parity linear / (Cond)Conv / BatchNorm blocks.

Activations are NCHW with the group (modality) axis folded into the batch,
group-major: [G*B, C, H, W].  A conditional conv mixes one kernel per group
and runs one dense conv per group; ``types`` is the per-group routing label,
a [G] tensor.

Parameters are f32 and cast to the activation dtype at use.  Their names are
those of the reference torch model's ``state_dict()``.  Initialization
reproduces torch's defaults from an explicit ``torch.Generator``:
kaiming-uniform(a=sqrt(5)) = U(+-1/sqrt(fan_in)) for conv and linear weights
and biases, xavier-normal over the stacked [E, Co, Ci, kh, kw] CondConv
expert bank with a zero bias (src/model.py:2095-2097).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.ops import (
    apply_act, batch_norm_apply, bilinear_resize, cond_route, conv2d,
    mix_experts, modality_conv2d, resolve_block_act)

_BN_TRAIN = ("BatchNorm in train mode (batch statistics, ordered running-"
             "stat EMA) comes with the training slice (ROADMAP.md, queue 1); "
             "call .eval() first")


def _uniform(shape, bound: float, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound,
                                                    generator=gen))


def _pair(k: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


class TorchLinear(nn.Module):
    """Linear with torch's default init; weight [out, in]."""

    def __init__(self, in_features: int, out_features: int,
                 gen: torch.Generator, bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = _uniform((out_features, in_features), bound, gen)
        self.bias = _uniform((out_features,), bound, gen) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class _Routing(nn.Module):
    """CondConv routing function: sigmoid(fc(type)), reference name
    ``_routing_fn.fc``."""

    def __init__(self, embeddings: int, num_experts: int,
                 gen: torch.Generator):
        super().__init__()
        self.fc = TorchLinear(embeddings, num_experts, gen)


class MaybeCondConv(nn.Module):
    """Conv2d or CondConv2d (src/model.py:2075-2120) on grouped activations.

    - is_cond=False: one kernel [Co, Ci, kh, kw], one conv over the batch.
    - is_cond=True with per-group types [G]: experts [E, Co, Ci, kh, kw]
      mixed once per group, one dense conv per group.
    """

    def __init__(self, in_ch: int, out_ch: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0, *,
                 gen: torch.Generator, is_cond: bool = False,
                 num_experts: int = 3, embeddings: int = 1,
                 bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = stride, padding
        self.is_cond, self.embeddings = is_cond, embeddings
        if not is_cond:
            bound = 1.0 / math.sqrt(in_ch * kh * kw)
            self.weight = _uniform((out_ch, in_ch, kh, kw), bound, gen)
            self.bias = _uniform((out_ch,), bound, gen) if bias else None
        else:
            receptive = in_ch * kh * kw
            std = math.sqrt(2.0 / (out_ch * receptive
                                   + num_experts * receptive))
            self.weight = nn.Parameter(torch.empty(
                num_experts, out_ch, in_ch, kh, kw).normal_(
                    0.0, std, generator=gen))
            self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
            self._routing_fn = _Routing(embeddings, num_experts, gen)

    def forward(self, x, types: Optional[torch.Tensor] = None):
        if not self.is_cond:
            return conv2d(x, self.weight, self.bias, self.stride, self.padding)
        t = types.float()[:, None].expand(-1, self.embeddings)   # [G, emb]
        fc = self._routing_fn.fc
        kernels = mix_experts(cond_route(t, fc.weight, fc.bias), self.weight)
        return modality_conv2d(x, kernels, self.bias, self.stride,
                               self.padding)


class BatchNormTorch(nn.Module):
    """nn.BatchNorm2d in eval mode: running statistics, eps 1e-5."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(_BN_TRAIN)
        return batch_norm_apply(x, self.running_mean, self.running_var,
                                self.weight, self.bias, self.eps)


class ConvBNAct(nn.Module):
    """Conv_BN_Act_New (``style='new'``: ``conv``, ``bn``) or Conv_BN_Act
    (``style='old'``: ``conv.0``, ``conv.1``), src/model.py:117-139,
    2122-2153.  The activation goes through quirk Q1."""

    def __init__(self, in_ch: int, features: int, *, gen: torch.Generator,
                 filter_size: int = 4, stride: int = 2, padding: int = 1,
                 activation: str = "lrelu", is_cond: bool = False,
                 fix_act_bug: bool = False, style: str = "new"):
        super().__init__()
        conv = MaybeCondConv(in_ch, features, filter_size, stride, padding,
                             gen=gen, is_cond=is_cond)
        bn = BatchNormTorch(features)
        self.style = style
        if style == "old":
            self.conv = nn.Sequential(conv, bn)
        else:
            self.conv, self.bn = conv, bn
        self.act = resolve_block_act(activation, fix_act_bug)

    def forward(self, x, types=None):
        if self.style == "old":
            conv, bn = self.conv[0], self.conv[1]
        else:
            conv, bn = self.conv, self.bn
        return apply_act(bn(conv(x, types)), self.act)


class ActDeconvBNConcat(nn.Module):
    """Act_Deconv_BN_Concat(_New), src/model.py:141-174, 2155-2195:
    act (quirk Q1) -> bilinear x2 (align_corners=True) -> conv3x3 ->
    [BN -> concat(skip, up)] unless last.  ``style='new'`` names the conv
    ``conv``; ``style='old'`` names it ``up.1``."""

    def __init__(self, in_ch: int, features: int, *, gen: torch.Generator,
                 activation: str = "relu", is_last: bool = False,
                 is_cond: bool = False, fix_act_bug: bool = False,
                 style: str = "new"):
        super().__init__()
        conv = MaybeCondConv(in_ch, features, 3, 1, 1, gen=gen,
                             is_cond=is_cond)
        self.style = style
        if style == "old":
            self.up = nn.ModuleList([nn.Identity(), conv])
        else:
            self.conv = conv
        self.is_last = is_last
        if not is_last:
            self.bn = BatchNormTorch(features)
        self.act = resolve_block_act(activation, fix_act_bug)

    def forward(self, x_down, x_up, types=None):
        x_up = apply_act(x_up, self.act)
        h, w = x_up.shape[-2:]
        x_up = bilinear_resize(x_up, (2 * h, 2 * w), align_corners=True)
        conv = self.up[1] if self.style == "old" else self.conv
        x_up = conv(x_up, types)
        if self.is_last:
            return x_up
        return torch.cat([x_down, self.bn(x_up)], dim=1)
