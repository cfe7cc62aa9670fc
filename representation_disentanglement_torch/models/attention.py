"""Spatial attention gate of the 'U+SA' output decoder.

Reference: ``SpatialAttentionLayer`` (src/model.py:1303-1327).  Its resizes
use F.upsample's default align_corners=False (quirk Q7).  The reference
names the output conv and BN ``W_out.0`` and ``W_out.1``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.layers import (
    BatchNormTorch, MaybeCondConv)
from representation_disentanglement_torch.ops import bilinear_resize


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

    def forward(self, x, g):
        x_post = self.W_x(x)
        g_post = bilinear_resize(self.W_g(g), x_post.shape[-2:],
                                 align_corners=False)
        alpha = torch.sigmoid(self.W_psi(F.relu(x_post + g_post)))
        alpha_up = bilinear_resize(alpha, x.shape[-2:], align_corners=False)
        out = self.W_out[1](self.W_out[0](alpha_up * x))
        return out, alpha_up
