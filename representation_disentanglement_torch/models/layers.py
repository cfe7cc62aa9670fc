"""Core modules: torch-parity linear / (Cond)Conv / BatchNorm blocks.

Activations are NCHW with the group (modality) axis folded into the batch,
group-major: [G*B, C, H, W].  A conditional conv routes on ``types``: per
group ([G] labels or [G, emb] vectors; one kernel mixed per group) or per
sample ([G, B, emb], or [N, emb] with one row per sample of x: one kernel
mixed per sample, ``percase_conv2d``).  Its ``cond_mode`` says how a
per-group CondConv runs (JAX layers.py:91-104): 'grouped', one dense conv
per group with its mixed kernel, or 'sum_experts', E dense convs over the
whole batch whose outputs are mixed by the routing weights.  BatchNorm in
train mode normalizes each group with its own batch statistics, so the
blocks that hold one pass G on: the length of ``types``, or ``groups``
where the block is not conditional.

``set_fuse_bn`` and ``set_cond_mode`` set the BatchNorm path and the
CondConv mode of every such layer inside a module: the counterparts of the
JAX package's process-wide ``set_bn_fused`` and ``set_cond_mode``.

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
    apply_act, batch_norm_apply, batch_stats, bilinear_resize, cond_route,
    conv2d, mix_experts, modality_conv2d, percase_conv2d, resolve_block_act,
    sequential_ema)
from representation_disentanglement_torch.ops.fused_bn import bn_train_fused
from representation_disentanglement_torch.parallel.mesh import (
    current_data_axis)


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


COND_MODES = ("grouped", "sum_experts")


def _check_cond_mode(mode: str) -> str:
    if mode not in COND_MODES:
        raise ValueError(f"cond_mode must be one of {COND_MODES}, not "
                         f"{mode!r}")
    return mode


class MaybeCondConv(nn.Module):
    """Conv2d or CondConv2d (src/model.py:2075-2120) on grouped activations.

    - is_cond=False: one kernel [Co, Ci, kh, kw], one conv over the batch.
    - is_cond=True with per-group types (a scalar, [G] or [G, emb]):
      experts [E, Co, Ci, kh, kw] mixed once per group; ``cond_mode``
      'grouped' runs one dense conv per group, 'sum_experts' E dense convs
      over the batch and mixes their outputs per group.
    - is_cond=True with per-sample types ([G, B, emb], or [N, emb] with N
      the rows of x): one kernel mixed per sample in f32, cast to x's
      dtype, and one grouped conv (``percase_conv2d``).
    """

    def __init__(self, in_ch: int, out_ch: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: Union[int, Tuple[int, int]] = 0, *,
                 gen: torch.Generator, is_cond: bool = False,
                 num_experts: int = 3, embeddings: int = 1,
                 bias: bool = True, cond_mode: str = "grouped",
                 dilation: int = 1):
        super().__init__()
        kh, kw = _pair(kernel_size)
        if is_cond and dilation != 1:
            raise ValueError("a CondConv is not dilated")
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.is_cond, self.embeddings = is_cond, embeddings
        self.cond_mode = _check_cond_mode(cond_mode)
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

    def forward(self, x, types=None):
        if not self.is_cond:
            return conv2d(x, self.weight, self.bias, self.stride,
                          self.padding, self.dilation)
        t = torch.as_tensor(types, device=x.device).float()
        # one routing vector per sample: [G, B, emb], or [N, emb] with a
        # row per sample of x (JAX's 4D-x call with [B, emb] types; with
        # one sample per group the two routings give the same kernels)
        per_sample = t.dim() == 3 or (t.dim() == 2
                                      and t.shape[0] == x.shape[0])
        if t.dim() == 0:
            t = t.reshape(1)
        if t.dim() == 1:                          # [G] labels -> [G, emb]
            t = t[:, None].expand(-1, self.embeddings)
        fc = self._routing_fn.fc
        if per_sample:
            route = cond_route(t.reshape(-1, t.shape[-1]), fc.weight,
                               fc.bias)                        # [N, E]
            return percase_conv2d(x, mix_experts(route, self.weight),
                                  self.bias, self.stride, self.padding)
        route = cond_route(t, fc.weight, fc.bias)              # [G, E]
        if self.cond_mode == "grouped":
            return modality_conv2d(x, mix_experts(route, self.weight),
                                   self.bias, self.stride, self.padding)
        # conv is linear in its kernel: the routed sum of the E experts'
        # outputs, accumulated in x's dtype (JAX layers.py:172-189)
        g, y = route.shape[0], None
        for e in range(self.weight.shape[0]):
            ye = conv2d(x, self.weight[e], None, self.stride, self.padding)
            ye = ye.reshape((g, -1) + ye.shape[1:])
            part = route[:, e].to(ye.dtype).reshape(g, 1, 1, 1, 1) * ye
            y = part if y is None else y + part
        y = y.reshape((-1,) + y.shape[2:])
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


def set_cond_mode(module: nn.Module, mode: str) -> None:
    """Set ``cond_mode`` ('grouped' | 'sum_experts') of every CondConv in
    ``module``."""
    _check_cond_mode(mode)
    for m in module.modules():
        if isinstance(m, MaybeCondConv):
            m.cond_mode = mode


def set_fuse_bn(module: nn.Module, on: bool) -> None:
    """Route every train-mode BatchNorm in ``module`` through the fused
    kernels (True) or the plain statistics and ``batch_norm_apply``
    (False)."""
    for m in module.modules():
        if isinstance(m, BatchNormTorch):
            m.fused = bool(on)


def resolve_device(device) -> torch.device:
    """``device``, or CUDA when it is None; raises when CUDA is asked for
    and there is no card."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the port on the CPU")
    return device


def _groups(types: Optional[torch.Tensor], groups: Optional[int]) -> int:
    if groups is not None:
        return groups
    return 1 if types is None else types.shape[0]


class BatchNormTorch(nn.Module):
    """nn.BatchNorm2d with the JAX package's semantics (JAX
    models/layers.py:222-269), eps 1e-5, momentum 0.1.

    Eval mode normalizes with the running statistics.  Train mode views x
    as G groups [G, B, C, H, W] and normalizes each with its own biased
    one-pass batch statistics; the gradient flows through the mean and the
    variance.  The running statistics then receive G ordered EMA updates,
    the variance's with the unbiased var * n / (n - 1), n = B*H*W: what the
    reference's shared BN called once per modality does.

    With ``fused`` (JAX: ``set_bn_fused``, layers.py:217-255) train mode
    goes through ``ops/fused_bn.bn_train_fused``, the CUDA kernels on the
    card: the same statistics, the normalization rounded once, and
    gradients through the statistics from the standard BatchNorm VJP.

    Inside a ``parallel.mesh.data_parallel`` scope the statistics are the
    global batch's (synchronized BatchNorm, as the JAX DP step's one
    computation over the global batch has them), the backward's channel
    sums too; the running statistics, from the global statistics and the
    global count, stay the same on every rank."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.fused = False
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, groups: int = 1):
        if not self.training:
            return batch_norm_apply(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, self.eps)
        axis = current_data_axis()
        if self.fused:
            y, mean, var = bn_train_fused(
                x, self.weight, self.bias, self.eps, groups,
                **({} if axis is None else {"axis": axis}))
        else:
            xg = x.reshape((groups, -1) + x.shape[1:])      # [G, B, C, H, W]
            mean, var = batch_stats(xg, (1, 3, 4), axis)    # [G, C]
            y = batch_norm_apply(xg, mean[:, None], var[:, None],
                                 self.weight, self.bias,
                                 self.eps).reshape(x.shape)
        n = x.shape[0] // groups * x.shape[2] * x.shape[3] \
            * (1 if axis is None else axis.size)
        with torch.no_grad():
            self.running_mean.copy_(sequential_ema(
                self.running_mean, mean, self.momentum))
            self.running_var.copy_(sequential_ema(
                self.running_var, var * (n / max(n - 1, 1)), self.momentum))
        return y


class ConvBNAct(nn.Module):
    """Conv_BN_Act_New (``style='new'``: ``conv``, ``bn``) or Conv_BN_Act
    (``style='old'``: ``conv.0``, ``conv.1``), src/model.py:117-139,
    2122-2153.  Without ``is_bn`` the block is the conv alone, named
    ``conv`` in either style (the reference's NoBN generators).  The
    activation goes through quirk Q1."""

    def __init__(self, in_ch: int, features: int, *, gen: torch.Generator,
                 filter_size: int = 4, stride: int = 2, padding: int = 1,
                 activation: str = "lrelu", is_cond: bool = False,
                 embeddings: int = 1, is_bn: bool = True,
                 fix_act_bug: bool = False, style: str = "new"):
        super().__init__()
        conv = MaybeCondConv(in_ch, features, filter_size, stride, padding,
                             gen=gen, is_cond=is_cond, embeddings=embeddings)
        self.style = style if is_bn else "new"
        if not is_bn:
            self.conv, self.bn = conv, None
        elif style == "old":
            self.conv = nn.Sequential(conv, BatchNormTorch(features))
        else:
            self.conv, self.bn = conv, BatchNormTorch(features)
        self.act = resolve_block_act(activation, fix_act_bug)

    def forward(self, x, types=None, groups: Optional[int] = None):
        if self.style == "old":
            conv, bn = self.conv[0], self.conv[1]
        else:
            conv, bn = self.conv, self.bn
        y = conv(x, types)
        if bn is not None:
            y = bn(y, _groups(types, groups))
        return apply_act(y, self.act)


class ActDeconvBNConcat(nn.Module):
    """Act_Deconv_BN_Concat(_New), src/model.py:141-174, 2155-2195:
    act (quirk Q1) -> bilinear x2 (align_corners=True) -> conv3x3 ->
    [BN (with ``is_bn``) -> concat(skip, up)] unless last.  ``style='new'``
    names the conv ``conv``; ``style='old'`` names it ``up.1``."""

    def __init__(self, in_ch: int, features: int, *, gen: torch.Generator,
                 activation: str = "relu", is_last: bool = False,
                 is_cond: bool = False, embeddings: int = 1,
                 is_bn: bool = True, fix_act_bug: bool = False,
                 style: str = "new"):
        super().__init__()
        conv = MaybeCondConv(in_ch, features, 3, 1, 1, gen=gen,
                             is_cond=is_cond, embeddings=embeddings)
        self.style = style
        if style == "old":
            self.up = nn.ModuleList([nn.Identity(), conv])
        else:
            self.conv = conv
        self.is_last = is_last
        self.bn = BatchNormTorch(features) if is_bn and not is_last else None
        self.act = resolve_block_act(activation, fix_act_bug)

    def forward(self, x_down, x_up, types=None,
                groups: Optional[int] = None):
        x_up = apply_act(x_up, self.act)
        h, w = x_up.shape[-2:]
        x_up = bilinear_resize(x_up, (2 * h, 2 * w), align_corners=True)
        conv = self.up[1] if self.style == "old" else self.conv
        x_up = conv(x_up, types)
        if self.is_last:
            return x_up
        if self.bn is not None:
            x_up = self.bn(x_up, _groups(types, groups))
        return torch.cat([x_down, x_up], dim=1)
