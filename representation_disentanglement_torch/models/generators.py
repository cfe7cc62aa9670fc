"""Output decoders (target synthesis / segmentation heads).

Ported: 'U+SA' -> GANShortGeneratorWithSpatialAttention
(src/model.py:341-390): a short U-Net whose skips pass through spatial
attention gates.  Non-conditional; its blocks carry quirk-Q1 identity
activations, and the first LeakyReLU is the one real nonlinearity.  The
reference names follow its module layout (``down_1.0``, ``down_i.conv.0/1``,
``up_i.up.1``, ``up_i.bn``, ``att_i.*``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.attention import (
    SpatialAttentionLayer)
from representation_disentanglement_torch.models.layers import (
    ActDeconvBNConcat, ConvBNAct, MaybeCondConv)
from representation_disentanglement_torch.ops import apply_act


def _down_modules(in_ch: int, f: int, gen, fix_act_bug: bool):
    """down_1 (conv; its LeakyReLU is applied in ``_down_path``) and four
    Conv_BN_Act blocks, registered by the generator as ``down_i``."""
    kw = dict(gen=gen, fix_act_bug=fix_act_bug, style="old")
    return {
        "down_1": nn.ModuleList([MaybeCondConv(in_ch, f, 4, 2, 1, gen=gen)]),
        "down_2": ConvBNAct(f, 2 * f, **kw),
        "down_3": ConvBNAct(2 * f, 4 * f, **kw),
        "down_4": ConvBNAct(4 * f, 8 * f, **kw),
        "down_5": ConvBNAct(8 * f, 8 * f, activation="no", **kw),
    }


def _down_path(m: nn.Module, x):
    d1 = F.leaky_relu(m.down_1[0](x), 0.2)
    d2 = m.down_2(d1)
    d3 = m.down_3(d2)
    d4 = m.down_4(d3)
    d5 = m.down_5(d4)
    return d1, d2, d3, d4, d5


class GANShortGeneratorWithSpatialAttention(nn.Module):
    """'U+SA': attention-gated skips."""

    def __init__(self, in_ch: int, out_num_ch: int, *, gen: torch.Generator,
                 first_num_ch: int = 64, output_activation: str = "softplus",
                 fix_act_bug: bool = False):
        super().__init__()
        f = first_num_ch
        for name, mod in _down_modules(in_ch, f, gen, fix_act_bug).items():
            setattr(self, name, mod)
        kw = dict(gen=gen, fix_act_bug=fix_act_bug, style="old")
        self.att_4 = SpatialAttentionLayer(8 * f, 8 * f, 8 * f, gen=gen)
        self.up_4 = ActDeconvBNConcat(8 * f, 8 * f, **kw)
        self.att_3 = SpatialAttentionLayer(4 * f, 16 * f, 4 * f, gen=gen)
        self.up_3 = ActDeconvBNConcat(16 * f, 4 * f, **kw)
        self.att_2 = SpatialAttentionLayer(2 * f, 8 * f, 2 * f, gen=gen)
        self.up_2 = ActDeconvBNConcat(8 * f, 2 * f, **kw)
        self.att_1 = SpatialAttentionLayer(f, 4 * f, f, gen=gen)
        self.up_1 = ActDeconvBNConcat(4 * f, f, **kw)
        self.output = ActDeconvBNConcat(2 * f, out_num_ch, is_last=True, **kw)
        self.output_activation = output_activation

    def forward(self, x):
        """x: [N, Cs, H, W] -> (y [N, out, H, W], {alpha_k})."""
        d1, d2, d3, d4, d5 = _down_path(self, x)
        c4, a4 = self.att_4(d4, d5)
        u4 = self.up_4(c4, d5)
        c3, a3 = self.att_3(d3, u4)
        u3 = self.up_3(c3, u4)
        c2, a2 = self.att_2(d2, u3)
        u2 = self.up_2(c2, u3)
        c1, a1 = self.att_1(d1, u2)
        u1 = self.up_1(c1, u2)
        out = self.output(None, u1)
        return (apply_act(out, self.output_activation),
                {"alpha_4": a4, "alpha_3": a3, "alpha_2": a2, "alpha_1": a1})


def make_output_decoder(target_model_name: str, in_ch: int, out_num_ch: int,
                        output_activation: str, *, gen: torch.Generator,
                        fix_act_bug: bool = False, first_num_ch: int = 64):
    if target_model_name == "U+SA":
        return GANShortGeneratorWithSpatialAttention(
            in_ch, out_num_ch, gen=gen, first_num_ch=first_num_ch,
            output_activation=output_activation, fix_act_bug=fix_act_bug)
    if target_model_name in ("U", "U+SA+CA", "U+SSA+CA"):
        raise NotImplementedError(
            f"output decoder {target_model_name!r} is not ported yet "
            "(ROADMAP.md, queue 1: 'Other model families')")
    raise ValueError(f"unknown target_model_name {target_model_name!r}")
