"""ZeroDose-GAN legacy generator variants (JAX ``models/legacy_generators.
py``; reference src/model.py:393-1301): a [split] down path and an up path
whose skips pass through attention gates, and the 8-down standard
generator with a split input.

None is reachable from the shipped configurations.  Kept as JAX keeps
them: quirk Q1 (block activations resolve to the identity), the
split-input channel layouts, and integer channel division in
``MultiAttentionLayer`` (the reference's float division cannot be built,
src/model.py:1441-1442).

Parameter names are the reference's: ``down_1.0`` (plain first conv) or
``down_1_{i}.0``, ``down_1_ca.W_down`` / ``.W_up`` and ``down_1_comb.0``
(split input); ``down_i.conv.0`` / ``.conv.1`` (``down_i.conv`` without
BatchNorm); ``up_i.up.1``, ``up_i.bn``, ``output.up.1``; the gates
``att_i.*``, or ``att_i_c.*`` (channel attention) and ``att_i_s.*`` with
``ca_all``.  Inputs are [B, C, H, W]; every BatchNorm is one group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.attention import (
    ChannelAttentionLayer, SpatialAttentionLayer,
    SymmetryGateResidualSpatialAttentionLayer)
from representation_disentanglement_torch.models.generators import (
    _down_modules, _down_path)
from representation_disentanglement_torch.models.layers import (
    ActDeconvBNConcat, ConvBNAct, MaybeCondConv, resolve_device)
from representation_disentanglement_torch.models.legacy import (
    MultiAttentionLayer, SymmetrySpatialAttentionLayer, _out_act,
    _run_standard_ups, _standard_ups, default_gen)
from representation_disentanglement_torch.ops import apply_act

# split-input channel layouts (channel slices of NCHW x):
# 3-channel ZeroDose: one branch per contrast (src/model.py:455-458)
SPLIT3 = (slice(0, 1), slice(1, 2), slice(2, 3))
# 4 single channels (GANStandardGenerator...One, src/model.py:533-536)
SPLIT4 = (slice(0, 1), slice(1, 2), slice(2, 3), slice(3, 4))
# 8-channel stroke layout: DWI | ADCx2 | TMAXx2 | CBV,CBF,MTT
# (src/model.py:851-854, 964-967)
SPLIT8 = (slice(2, 3), slice(0, 2), slice(6, 8), slice(3, 6))

ATTENTIONS = ("sa", "ssa", "ssa_res", "sgrsa", "multi")


class _SplitDown1(nn.Module):
    """Per-branch stride-2 conv(4,2,1) + LeakyReLU on channel slices
    (``down_1_{i}.0``), concat, optional SE channel attention
    (``down_1_ca``), 1x1 conv + LeakyReLU (``down_1_comb.0``)
    (src/model.py:404-419 etc.).  Registered on the generator itself, so
    that the names are the reference's."""

    @staticmethod
    def build(m: nn.Module, f: int, splits, use_ca: bool, gen) -> None:
        m.splits = tuple(splits)
        for i, sl in enumerate(m.splits, start=1):
            setattr(m, f"down_1_{i}", nn.ModuleList([MaybeCondConv(
                sl.stop - sl.start, f, 4, 2, 1, gen=gen)]))
        if use_ca:
            m.down_1_ca = ChannelAttentionLayer(len(splits) * f, 4, gen=gen)
        m.down_1_comb = nn.ModuleList([MaybeCondConv(
            len(splits) * f, f, 1, 1, 0, gen=gen)])

    @staticmethod
    def run(m: nn.Module, x):
        h = torch.cat([F.leaky_relu(getattr(m, f"down_1_{i}")[0](x[:, sl]),
                                    0.2)
                       for i, sl in enumerate(m.splits, start=1)], dim=1)
        if hasattr(m, "down_1_ca"):
            h, _ = m.down_1_ca(h)
        return F.leaky_relu(m.down_1_comb[0](h), 0.2)


class _LegacyAttGenerator(nn.Module):
    """The shared body: [split] down path -> attention-gated up path.

    attention: 'sa' | 'ssa' | 'ssa_res' | 'sgrsa' | 'multi'; ``splits``
    empty for a plain first conv; ``use_ca_comb`` SE on the concatenated
    split branches; ``ca_all`` a per-level channel attention added to the
    gated skip (src/model.py:983-998); ``is_bn`` False drops every
    BatchNorm."""

    def __init__(self, in_ch: int, out_num_ch: int, attention: str,
                 splits: Tuple[slice, ...] = (), use_ca_comb: bool = False,
                 ca_all: bool = False, first_num_ch: int = 64,
                 output_activation: str = "softplus", is_bn: bool = True,
                 fix_act_bug: bool = False, *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if attention not in ATTENTIONS:
            raise ValueError(f"unknown attention {attention!r}")
        gen, f = default_gen(gen), first_num_ch
        self.out_act = _out_act(output_activation)
        self.split = bool(splits)
        downs = _down_modules(in_ch, f, gen, fix_act_bug, is_bn=is_bn)
        if self.split:
            del downs["down_1"]
            _SplitDown1.build(self, f, splits, use_ca_comb, gen)
        for name, mod in downs.items():
            setattr(self, name, mod)
        self.ca_all = ca_all
        kw = dict(gen=gen, fix_act_bug=fix_act_bug, style="old", is_bn=is_bn)
        # level: (skip channels, gate channels, channel-attention factor)
        for lvl, ch, gate_ch, sf in ((4, 8 * f, 8 * f, 8),
                                     (3, 4 * f, 16 * f, 4),
                                     (2, 2 * f, 8 * f, 2), (1, f, 4 * f, 1)):
            if attention == "sa":
                gate = SpatialAttentionLayer(ch, gate_ch, ch, gen=gen)
            elif attention in ("ssa", "ssa_res"):
                gate = SymmetrySpatialAttentionLayer(
                    ch, gate_ch, ch, gen=gen, residual=attention == "ssa_res")
            elif attention == "sgrsa":
                gate = SymmetryGateResidualSpatialAttentionLayer(
                    ch, gate_ch, ch, gen=gen, is_bn=is_bn)
            else:
                gate = MultiAttentionLayer(ch, gate_ch, gen=gen, is_bn=is_bn)
            if ca_all:
                setattr(self, f"att_{lvl}_c",
                        ChannelAttentionLayer(ch, sf, gen=gen))
                setattr(self, f"att_{lvl}_s", gate)
            else:
                setattr(self, f"att_{lvl}", gate)
            setattr(self, f"up_{lvl}", ActDeconvBNConcat(
                gate_ch, ch, **kw))
        self.output = ActDeconvBNConcat(2 * f, out_num_ch, is_last=True, **kw)
        self.to(resolve_device(device))

    def forward(self, x):
        """x: [B, C, H, W] -> (y [B, out, H, W], {alpha_4 .. alpha_1})."""
        if self.split:
            d1 = _SplitDown1.run(self, x)
            _, d2, d3, d4, d5 = _down_path(self, None, 1, d1=d1)
        else:
            d1, d2, d3, d4, d5 = _down_path(self, x, 1)
        alphas, g = {}, d5
        for lvl, d in ((4, d4), (3, d3), (2, d2), (1, d1)):
            if self.ca_all:
                cs, alphas[f"alpha_{lvl}"] = getattr(self, f"att_{lvl}_s")(
                    d, g)
                cs = getattr(self, f"att_{lvl}_c")(d)[0] + cs
            else:
                cs, alphas[f"alpha_{lvl}"] = getattr(self, f"att_{lvl}")(
                    d, g)
            g = getattr(self, f"up_{lvl}")(cs, g)
        return apply_act(self.output(None, g), self.out_act), alphas


def GANShortGeneratorWithSplitInputAndSpatialAttention(
        out_num_ch, in_num_ch=3, first_num_ch=64,
        output_activation="softplus", fix_act_bug=False, *, gen=None,
        device=None):
    """src/model.py:393-471: 3 single-channel down branches + SA gates."""
    return _LegacyAttGenerator(
        in_num_ch, out_num_ch, "sa", splits=SPLIT3,
        first_num_ch=first_num_ch, output_activation=output_activation,
        fix_act_bug=fix_act_bug, gen=gen, device=device)


def GANShortGeneratorWithSymmetrySpatialAttention(
        out_num_ch, in_num_ch=3, first_num_ch=64,
        output_activation="softplus", fix_act_bug=False, *, gen=None,
        device=None):
    """src/model.py:550-599."""
    return _LegacyAttGenerator(
        in_num_ch, out_num_ch, "ssa", first_num_ch=first_num_ch,
        output_activation=output_activation, fix_act_bug=fix_act_bug,
        gen=gen, device=device)


def GANShortGeneratorWithSymmetryResidualSpatialAttention(
        out_num_ch, in_num_ch=3, first_num_ch=64,
        output_activation="softplus", fix_act_bug=False, *, gen=None,
        device=None):
    """src/model.py:601-650."""
    return _LegacyAttGenerator(
        in_num_ch, out_num_ch, "ssa_res", first_num_ch=first_num_ch,
        output_activation=output_activation, fix_act_bug=fix_act_bug,
        gen=gen, device=device)


def GANShortGeneratorWithSymmetryGateResidualSpatialAttention(
        out_num_ch, in_num_ch=3, first_num_ch=64,
        output_activation="softplus", fix_act_bug=False, *, gen=None,
        device=None):
    """src/model.py:652-701."""
    return _LegacyAttGenerator(
        in_num_ch, out_num_ch, "sgrsa", first_num_ch=first_num_ch,
        output_activation=output_activation, fix_act_bug=fix_act_bug,
        gen=gen, device=device)


def GANShortGeneratorWithSplitInputAndSymmetryGateResidualSpatialAttention(
        out_num_ch, in_num_ch=3, first_num_ch=64,
        output_activation="softplus", fix_act_bug=False, *, gen=None,
        device=None):
    """src/model.py:703-768."""
    return _LegacyAttGenerator(
        in_num_ch, out_num_ch, "sgrsa", splits=SPLIT3,
        first_num_ch=first_num_ch, output_activation=output_activation,
        fix_act_bug=fix_act_bug, gen=gen, device=device)


def GANShortGeneratorWithSplitInputChannelAttentionOneAndSpatialAttention(
        out_num_ch, in_num_ch=3, first_num_ch=64,
        output_activation="softplus", fix_act_bug=False, *, gen=None,
        device=None):
    """src/model.py:770-878: split branches + SE on the concat + SGRSA
    gates (the gates are the symmetry-gate-residual layer despite the
    name, src/model.py:822-829).  ``in_num_ch`` 3 selects the ZeroDose
    layout, any other the 8-channel stroke layout."""
    return _LegacyAttGenerator(
        in_num_ch, out_num_ch, "sgrsa",
        splits=SPLIT3 if in_num_ch == 3 else SPLIT8, use_ca_comb=True,
        first_num_ch=first_num_ch, output_activation=output_activation,
        fix_act_bug=fix_act_bug, gen=gen, device=device)


def GANShortGeneratorWithSplitInputChannelAttentionAllAndSpatialAttention(
        out_num_ch, in_num_ch=3, first_num_ch=64,
        output_activation="softplus", fix_act_bug=False, *, gen=None,
        device=None):
    """src/model.py:880-1000 ('current best model 2019/6/12'): split + SE
    comb + per-level CA added to the SGRSA-gated skips."""
    return _LegacyAttGenerator(
        in_num_ch, out_num_ch, "sgrsa",
        splits=SPLIT3 if in_num_ch == 3 else SPLIT8, use_ca_comb=True,
        ca_all=True, first_num_ch=first_num_ch,
        output_activation=output_activation, fix_act_bug=fix_act_bug,
        gen=gen, device=device)


def GANShortGeneratorWithSplitInputChannelAttentionAllAndSpatialAttentionNoBN(
        out_num_ch, in_num_ch=3, first_num_ch=64,
        output_activation="softplus", fix_act_bug=False, *, gen=None,
        device=None):
    """src/model.py:1139-1226: the CA-All variant with every BatchNorm
    off."""
    return _LegacyAttGenerator(
        in_num_ch, out_num_ch, "sgrsa", splits=SPLIT3, use_ca_comb=True,
        ca_all=True, is_bn=False, first_num_ch=first_num_ch,
        output_activation=output_activation, fix_act_bug=fix_act_bug,
        gen=gen, device=device)


def GANShortGeneratorWithSplitInputMultiAttentionAll(
        out_num_ch, in_num_ch=3, first_num_ch=64,
        output_activation="softplus", fix_act_bug=False, *, gen=None,
        device=None):
    """src/model.py:1228-1301 (dual attention); integer channel division
    in its gates.  The 8x8 pooled channel gate needs d4 of at least 8x8,
    an input of at least 128x128."""
    return _LegacyAttGenerator(
        in_num_ch, out_num_ch, "multi", splits=SPLIT3, use_ca_comb=True,
        first_num_ch=first_num_ch, output_activation=output_activation,
        fix_act_bug=fix_act_bug, gen=gen, device=device)


class GANStandardGeneratorWithSplitInputChannelAttentionOne(nn.Module):
    """src/model.py:473-548: 4 single-channel split branches + SE + the
    8-down pix2pix body, no attention gates."""

    def __init__(self, out_num_ch: int, in_num_ch: int = 4,
                 first_num_ch: int = 64, output_activation: str = "softplus",
                 fix_act_bug: bool = False, *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen, f = default_gen(gen), first_num_ch
        self.out_act = _out_act(output_activation)
        _SplitDown1.build(self, f, SPLIT4, True, gen)
        chans = [f, 2 * f, 4 * f] + [8 * f] * 5
        for i in range(2, 9):
            setattr(self, f"down_{i}", ConvBNAct(
                chans[i - 2], chans[i - 1], gen=gen,
                activation="no" if i == 8 else "lrelu",
                fix_act_bug=fix_act_bug, style="old"))
        _standard_ups(self, f, out_num_ch, gen, fix_act_bug)
        self.to(resolve_device(device))

    def forward(self, x):
        downs = [_SplitDown1.run(self, x)]
        for i in range(2, 9):
            downs.append(getattr(self, f"down_{i}")(downs[-1]))
        return apply_act(_run_standard_ups(self, downs), self.out_act), {}


FACTORIES = {
    "split_sa": GANShortGeneratorWithSplitInputAndSpatialAttention,
    "ssa": GANShortGeneratorWithSymmetrySpatialAttention,
    "ssa_res": GANShortGeneratorWithSymmetryResidualSpatialAttention,
    "sgrsa": GANShortGeneratorWithSymmetryGateResidualSpatialAttention,
    "split_sgrsa":
        GANShortGeneratorWithSplitInputAndSymmetryGateResidualSpatialAttention,
    "split_ca_one_sa":
        GANShortGeneratorWithSplitInputChannelAttentionOneAndSpatialAttention,
    "split_ca_all_sa":
        GANShortGeneratorWithSplitInputChannelAttentionAllAndSpatialAttention,
    "split_ca_all_sa_nobn":
        GANShortGeneratorWithSplitInputChannelAttentionAllAndSpatialAttentionNoBN,
    "split_multi": GANShortGeneratorWithSplitInputMultiAttentionAll,
}
