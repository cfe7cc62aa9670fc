"""Attention gates of the output decoders.

Reference: ``SpatialAttentionLayer`` (src/model.py:1303-1327),
``SymmetryGateResidualSpatialAttentionLayer`` (src/model.py:1389-1415) and
``ChannelAttentionLayer`` (squeeze-excitation, src/model.py:1417-1433).
Their resizes use F.upsample's default align_corners=False (quirk Q7).  The
reference names the output conv and BN ``W_out.0`` and ``W_out.1``.  The
symmetry gate flips along H, dim 2 of NCHW (left-right brain symmetry in
the stored orientation).  Activations are [G*B, C, H, W]; ``groups`` is G,
for the train-mode BatchNorm.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.layers import (
    BatchNormTorch, MaybeCondConv, TorchLinear)
from representation_disentanglement_torch.ops import bilinear_resize


def out_conv_bn(w_out: nn.Module, x, groups: int):
    """A gate's output layer: ``W_out`` = [conv, BN], or the conv alone."""
    if isinstance(w_out, nn.ModuleList):
        return w_out[1](w_out[0](x), groups)
    return w_out(x)


class SpatialAttentionLayer(nn.Module):
    def __init__(self, in_ch: int, gate_ch: int, inter_num_ch: int, *,
                 gen: torch.Generator, sample_factor=(2, 2)):
        super().__init__()
        self.W_x = MaybeCondConv(in_ch, inter_num_ch, sample_factor,
                                 sample_factor, 0, gen=gen, bias=False)
        self.W_g = MaybeCondConv(gate_ch, inter_num_ch, 1, 1, 0, gen=gen)
        self.W_psi = MaybeCondConv(inter_num_ch, 1, 1, 1, 0, gen=gen)
        self.W_out = nn.ModuleList([
            MaybeCondConv(in_ch, in_ch, 1, 1, 0, gen=gen),
            BatchNormTorch(in_ch)])

    def forward(self, x, g, groups: int = 1):
        x_post = self.W_x(x)
        g_post = bilinear_resize(self.W_g(g), x_post.shape[-2:],
                                 align_corners=False)
        alpha = torch.sigmoid(self.W_psi(F.relu(x_post + g_post)))
        alpha_up = bilinear_resize(alpha, x.shape[-2:], align_corners=False)
        return out_conv_bn(self.W_out, alpha_up * x, groups), alpha_up


class SymmetryGateResidualSpatialAttentionLayer(nn.Module):
    """Gate-only symmetry attention: alpha from g and |g - flip_H(g)|, the
    output (1 + alpha) * x through ``W_out`` (the conv and BN ``W_out.0``,
    ``W_out.1``; without ``is_bn`` the conv alone, ``W_out``)."""

    def __init__(self, in_ch: int, gate_ch: int, inter_num_ch: int, *,
                 gen: torch.Generator, is_bn: bool = True):
        super().__init__()
        self.W_g = MaybeCondConv(gate_ch, inter_num_ch, 1, 1, 0, gen=gen)
        self.W_g_diff = MaybeCondConv(gate_ch, inter_num_ch, 1, 1, 0,
                                      gen=gen)
        self.W_psi = MaybeCondConv(inter_num_ch, 1, 1, 1, 0, gen=gen)
        out = MaybeCondConv(in_ch, in_ch, 1, 1, 0, gen=gen)
        self.W_out = (nn.ModuleList([out, BatchNormTorch(in_ch)]) if is_bn
                      else out)

    def forward(self, x, g, groups: int = 1):
        g_diff = (g - torch.flip(g, dims=[2])).abs()
        g_post = F.relu(self.W_g(g) + self.W_g_diff(g_diff))
        alpha = torch.sigmoid(self.W_psi(g_post))
        alpha_up = bilinear_resize(alpha, x.shape[-2:], align_corners=False)
        return out_conv_bn(self.W_out, (1.0 + alpha_up) * x, groups), alpha_up


class ChannelAttentionLayer(nn.Module):
    """Squeeze-excitation: alpha = sigmoid(W_up(relu(W_down(mean_HW x)))),
    output (1 + alpha) * x."""

    def __init__(self, in_ch: int, sample_factor: int, *,
                 gen: torch.Generator):
        super().__init__()
        self.W_down = TorchLinear(in_ch, in_ch // sample_factor, gen)
        self.W_up = TorchLinear(in_ch // sample_factor, in_ch, gen)

    def forward(self, x):
        alpha = torch.sigmoid(self.W_up(F.relu(self.W_down(
            x.mean(dim=(-2, -1))))))
        return (1.0 + alpha[:, :, None, None]) * x, alpha
