"""Anatomy encoder (U-Net encoder/decoder halves) and the anatomy activation.

Reference: ``AnatomyEncoderEncNew`` (src/model.py:2218-2245): 5 stride-2
stages, the first a raw conv + LeakyReLU(0.2), stages 2-5 Conv_BN_Act_New
(identity activations via quirk Q1); ``AnatomyEncoderDecNew``
(src/model.py:2271-2296): 4 up blocks with skip concat and a last block
emitting the s-logits.  Activations are [M*B, C, H, W], types [M].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.layers import (
    ActDeconvBNConcat, ConvBNAct, MaybeCondConv)


class AnatomyEncoderEnc(nn.Module):
    def __init__(self, in_ch: int, *, gen: torch.Generator,
                 first_num_ch: int = 32, is_cond: bool = False,
                 fix_act_bug: bool = False):
        super().__init__()
        f = first_num_ch
        kw = dict(gen=gen, is_cond=is_cond, fix_act_bug=fix_act_bug)
        self.down_1 = MaybeCondConv(in_ch, f, 4, 2, 1, gen=gen,
                                    is_cond=is_cond)
        self.down_2 = ConvBNAct(f, 2 * f, **kw)
        self.down_3 = ConvBNAct(2 * f, 4 * f, **kw)
        self.down_4 = ConvBNAct(4 * f, 8 * f, **kw)
        self.down_5 = ConvBNAct(8 * f, 8 * f, activation="no", **kw)

    def forward(self, x, types=None):
        d1 = F.leaky_relu(self.down_1(x, types), 0.2)   # real act (:2227)
        d2 = self.down_2(d1, types)
        d3 = self.down_3(d2, types)
        d4 = self.down_4(d3, types)
        d5 = self.down_5(d4, types)
        return d1, d2, d3, d4, d5


class AnatomyEncoderDec(nn.Module):
    def __init__(self, *, gen: torch.Generator, first_num_ch: int = 32,
                 out_num_ch: int = 4, is_cond: bool = False,
                 fix_act_bug: bool = False):
        super().__init__()
        f = first_num_ch
        kw = dict(gen=gen, is_cond=is_cond, fix_act_bug=fix_act_bug)
        self.up_4 = ActDeconvBNConcat(8 * f, 8 * f, **kw)
        self.up_3 = ActDeconvBNConcat(16 * f, 4 * f, **kw)
        self.up_2 = ActDeconvBNConcat(8 * f, 2 * f, **kw)
        self.up_1 = ActDeconvBNConcat(4 * f, f, **kw)
        self.output = ActDeconvBNConcat(2 * f, out_num_ch, is_last=True, **kw)

    def forward(self, feats, types=None):
        d1, d2, d3, d4, d5 = feats
        u4 = self.up_4(d4, d5, types)
        u3 = self.up_3(d3, u4, types)
        u2 = self.up_2(d2, u3, types)
        u1 = self.up_1(d1, u2, types)
        return self.output(None, u1, types)


def anatomy_activation(s_logits: torch.Tensor, mask_img: torch.Tensor,
                       ana_dec_act: str = "softmax",
                       softmax_remove_mask: bool = True) -> torch.Tensor:
    """s activation (src/model.py:3145-3155).

    s_logits: [M*B, Cs, H, W]; mask_img: [B, H, W] background map.  With
    softmax_remove_mask a 100*mask_img background channel is put in front
    before the softmax and dropped after it."""
    if ana_dec_act == "softplus":
        return F.softplus(s_logits)
    if not softmax_remove_mask:
        return torch.softmax(s_logits, dim=1)
    groups = s_logits.shape[0] // mask_img.shape[0]
    bg = (100.0 * mask_img).to(s_logits.dtype)[:, None]       # [B, 1, H, W]
    bg = bg.repeat(groups, 1, 1, 1)                           # [M*B, 1, H, W]
    cat = torch.cat([bg, s_logits], dim=1)
    return torch.softmax(cat, dim=1)[:, 1:]
