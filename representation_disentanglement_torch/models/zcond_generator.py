"""z-conditioned U-Net input decoder (JAX ``models/zcond_generator.py``;
reference ``GANShortGeneratorNew``, src/model.py:2714-2766, the
alternative to SPADE at src/model.py:3118-3119).

Every conv is a CondConv routed on each sample's z: one kernel mixed per
sample in f32, cast to the activation dtype, and one grouped conv over the
batch (``ops/conv.percase_conv2d``).  The layout is the anatomy U-Net's
(``down_1``, ``down_i.conv`` / ``.bn``, ``up_i.conv`` / ``.bn``,
``output.conv``); the block activations go through quirk Q1.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.layers import (
    ActDeconvBNConcat, ConvBNAct, MaybeCondConv, resolve_device)
from representation_disentanglement_torch.models.legacy import default_gen
from representation_disentanglement_torch.ops import apply_act


class GANShortGeneratorZCond(nn.Module):
    def __init__(self, in_ch: int, out_num_ch: int, first_num_ch: int = 64,
                 z_size: int = 16, output_activation: str = "softplus",
                 fix_act_bug: bool = False, *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen, f = default_gen(gen), first_num_ch
        kw = dict(gen=gen, is_cond=True, embeddings=z_size,
                  fix_act_bug=fix_act_bug)
        self.down_1 = MaybeCondConv(in_ch, f, 4, 2, 1, gen=gen, is_cond=True,
                                    embeddings=z_size)
        self.down_2 = ConvBNAct(f, 2 * f, **kw)
        self.down_3 = ConvBNAct(2 * f, 4 * f, **kw)
        self.down_4 = ConvBNAct(4 * f, 8 * f, **kw)
        self.down_5 = ConvBNAct(8 * f, 8 * f, activation="no", **kw)
        self.up_4 = ActDeconvBNConcat(8 * f, 8 * f, **kw)
        self.up_3 = ActDeconvBNConcat(16 * f, 4 * f, **kw)
        self.up_2 = ActDeconvBNConcat(8 * f, 2 * f, **kw)
        self.up_1 = ActDeconvBNConcat(4 * f, f, **kw)
        self.output = ActDeconvBNConcat(2 * f, out_num_ch, is_last=True,
                                        **kw)
        # the reference's fallback: any other name is softplus
        self.out_act = (output_activation if output_activation in
                        ("sigmoid", "tanh", "no") else "softplus")
        self.to(resolve_device(device))

    def forward(self, x, z):
        """x: [G*B, C, H, W] group-major; z: [G, B, z_size] (or [B,
        z_size], one group) -> y [G*B, out, H, W].  Each of the G groups
        gets its own train-mode BatchNorm statistics."""
        if z.dim() == 2:
            z = z[None]
        g = z.shape[0]
        d1 = F.leaky_relu(self.down_1(x, z), 0.2)
        d2 = self.down_2(d1, z, g)
        d3 = self.down_3(d2, z, g)
        d4 = self.down_4(d3, z, g)
        d5 = self.down_5(d4, z, g)
        u = self.up_4(d4, d5, z, g)
        u = self.up_3(d3, u, z, g)
        u = self.up_2(d2, u, z, g)
        u = self.up_1(d1, u, z, g)
        return apply_act(self.output(None, u, z, g), self.out_act)
