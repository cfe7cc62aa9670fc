"""Output decoders (target synthesis / segmentation heads).

The reference's dispatch on ``target_model_name`` (src/model.py:2955-2964):
- 'U'        -> GANShortGenerator (src/model.py:261-299), a short U-Net;
- 'U+SA'     -> GANShortGeneratorWithSpatialAttention (src/model.py:
  341-390), whose skips pass through spatial attention gates;
- 'U+SA+CA'  -> ...ChannelAttentionAllAndSpatialAttention (src/model.py:
  1070-1135) and 'U+SSA+CA' -> ...ChannelAttentionAllAndSymmetrySpatial
  Attention (src/model.py:1002-1067): each skip is the channel-attended
  skip plus the (symmetry) spatially attended one.
All are non-conditional; their blocks carry quirk-Q1 identity activations,
and the first LeakyReLU is the one real nonlinearity.  The reference names
follow its module layout (``down_1.0``, ``down_i.conv.0/1``, ``up_i.up.1``,
``up_i.bn``, ``att_i.*``; ``att_i_c.*`` and ``att_i_s.*`` in the
channel-attention variants).  Inputs are [G*B, C, H, W] group-major;
``groups`` is G, for the train-mode BatchNorms.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.attention import (
    ChannelAttentionLayer, SpatialAttentionLayer,
    SymmetryGateResidualSpatialAttentionLayer)
from representation_disentanglement_torch.models.layers import (
    ActDeconvBNConcat, ConvBNAct, MaybeCondConv)
from representation_disentanglement_torch.ops import apply_act


def _down_modules(in_ch: int, f: int, gen, fix_act_bug: bool,
                  is_bn: bool = True):
    """down_1 (conv; its LeakyReLU is applied in ``_down_path``) and four
    Conv_BN_Act blocks, registered by the generator as ``down_i``."""
    kw = dict(gen=gen, fix_act_bug=fix_act_bug, style="old", is_bn=is_bn)
    return {
        "down_1": nn.ModuleList([MaybeCondConv(in_ch, f, 4, 2, 1, gen=gen)]),
        "down_2": ConvBNAct(f, 2 * f, **kw),
        "down_3": ConvBNAct(2 * f, 4 * f, **kw),
        "down_4": ConvBNAct(4 * f, 8 * f, **kw),
        "down_5": ConvBNAct(8 * f, 8 * f, activation="no", **kw),
    }


def _down_path(m: nn.Module, x, groups: int, d1=None):
    """d1 .. d5; ``d1`` given (a split first layer) skips ``down_1``."""
    if d1 is None:
        d1 = F.leaky_relu(m.down_1[0](x), 0.2)
    d2 = m.down_2(d1, groups=groups)
    d3 = m.down_3(d2, groups=groups)
    d4 = m.down_4(d3, groups=groups)
    d5 = m.down_5(d4, groups=groups)
    return d1, d2, d3, d4, d5


def _up_modules(m: nn.Module, f: int, out_num_ch: int, gen,
                fix_act_bug: bool) -> None:
    """up_4 .. up_1 and the last block ``output``."""
    kw = dict(gen=gen, fix_act_bug=fix_act_bug, style="old")
    m.up_4 = ActDeconvBNConcat(8 * f, 8 * f, **kw)
    m.up_3 = ActDeconvBNConcat(16 * f, 4 * f, **kw)
    m.up_2 = ActDeconvBNConcat(8 * f, 2 * f, **kw)
    m.up_1 = ActDeconvBNConcat(4 * f, f, **kw)
    m.output = ActDeconvBNConcat(2 * f, out_num_ch, is_last=True, **kw)


class GANShortGenerator(nn.Module):
    """'U': the plain short U-Net."""

    def __init__(self, in_ch: int, out_num_ch: int, *, gen: torch.Generator,
                 first_num_ch: int = 64, output_activation: str = "softplus",
                 fix_act_bug: bool = False):
        super().__init__()
        f = first_num_ch
        for name, mod in _down_modules(in_ch, f, gen, fix_act_bug).items():
            setattr(self, name, mod)
        _up_modules(self, f, out_num_ch, gen, fix_act_bug)
        self.output_activation = output_activation

    def forward(self, x, groups: int = 1):
        """x: [N, Cs, H, W] -> (y [N, out, H, W], {})."""
        g = groups
        d1, d2, d3, d4, d5 = _down_path(self, x, g)
        u4 = self.up_4(d4, d5, groups=g)
        u3 = self.up_3(d3, u4, groups=g)
        u2 = self.up_2(d2, u3, groups=g)
        u1 = self.up_1(d1, u2, groups=g)
        return apply_act(self.output(None, u1), self.output_activation), {}


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

    def forward(self, x, groups: int = 1):
        """x: [N, Cs, H, W] -> (y [N, out, H, W], {alpha_k}).  ``groups``:
        the number of group-major groups in N, each with its own train-mode
        BatchNorm statistics."""
        g = groups
        d1, d2, d3, d4, d5 = _down_path(self, x, g)
        c4, a4 = self.att_4(d4, d5, g)
        u4 = self.up_4(c4, d5, groups=g)
        c3, a3 = self.att_3(d3, u4, g)
        u3 = self.up_3(c3, u4, groups=g)
        c2, a2 = self.att_2(d2, u3, g)
        u2 = self.up_2(c2, u3, groups=g)
        c1, a1 = self.att_1(d1, u2, g)
        u1 = self.up_1(c1, u2, groups=g)
        out = self.output(None, u1)
        return (apply_act(out, self.output_activation),
                {"alpha_4": a4, "alpha_3": a3, "alpha_2": a2, "alpha_1": a1})


class ChannelAttentionGenerator(nn.Module):
    """'U+SA+CA' and, with ``symmetry``, 'U+SSA+CA': at level i (4 .. 1)
    the skip is ``att_i_c`` (channel attention, reduction 8, 4, 2, 1) plus
    ``att_i_s`` (spatial, or symmetry spatial, attention gated by the level
    below), and ``up_i`` takes it with the level below."""

    def __init__(self, in_ch: int, out_num_ch: int, *, gen: torch.Generator,
                 first_num_ch: int = 64, output_activation: str = "softplus",
                 fix_act_bug: bool = False, symmetry: bool = False):
        super().__init__()
        f = first_num_ch
        for name, mod in _down_modules(in_ch, f, gen, fix_act_bug).items():
            setattr(self, name, mod)
        gate = (SymmetryGateResidualSpatialAttentionLayer if symmetry
                else SpatialAttentionLayer)
        # level: (skip channels, gate channels, channel-attention factor)
        for lvl, ch, gate_ch, sf in ((4, 8 * f, 8 * f, 8),
                                     (3, 4 * f, 16 * f, 4),
                                     (2, 2 * f, 8 * f, 2), (1, f, 4 * f, 1)):
            setattr(self, f"att_{lvl}_c",
                    ChannelAttentionLayer(ch, sf, gen=gen))
            setattr(self, f"att_{lvl}_s", gate(ch, gate_ch, ch, gen=gen))
        _up_modules(self, f, out_num_ch, gen, fix_act_bug)
        self.output_activation = output_activation

    def forward(self, x, groups: int = 1):
        """x: [N, Cs, H, W] -> (y [N, out, H, W], {alpha_k})."""
        d1, d2, d3, d4, d5 = _down_path(self, x, groups)
        alphas, g = {}, d5
        for lvl, d in ((4, d4), (3, d3), (2, d2), (1, d1)):
            cc, _ = getattr(self, f"att_{lvl}_c")(d)
            cs, alphas[f"alpha_{lvl}"] = getattr(self, f"att_{lvl}_s")(
                d, g, groups)
            g = getattr(self, f"up_{lvl}")(cc + cs, g, groups=groups)
        return (apply_act(self.output(None, g), self.output_activation),
                alphas)


def make_output_decoder(target_model_name: str, in_ch: int, out_num_ch: int,
                        output_activation: str, *, gen: torch.Generator,
                        fix_act_bug: bool = False, first_num_ch: int = 64):
    if target_model_name == "U+SA":
        return GANShortGeneratorWithSpatialAttention(
            in_ch, out_num_ch, gen=gen, first_num_ch=first_num_ch,
            output_activation=output_activation, fix_act_bug=fix_act_bug)
    if target_model_name == "U":
        return GANShortGenerator(
            in_ch, out_num_ch, gen=gen, first_num_ch=first_num_ch,
            output_activation=output_activation, fix_act_bug=fix_act_bug)
    if target_model_name in ("U+SA+CA", "U+SSA+CA"):
        return ChannelAttentionGenerator(
            in_ch, out_num_ch, gen=gen, first_num_ch=first_num_ch,
            output_activation=output_activation, fix_act_bug=fix_act_bug,
            symmetry=target_model_name == "U+SSA+CA")
    raise ValueError(f"unknown target_model_name {target_model_name!r}")
