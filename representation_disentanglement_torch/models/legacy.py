"""Legacy / lineage models of the reference (JAX ``models/legacy.py``;
reference src/model.py:20-112, 209-339, 1329-1467, 1606-1684, 2803-2898):
the ZeroDose-GAN / GBM-VAE / Lowdose modules that the active entry point
does not reach.

- ``UNet`` with ``ConvDoubleBlock`` (maxpool downs, real ReLUs); the
  reference's 'linear' output activation crashes (nn.Linear() without
  arguments, src/model.py:96), so ``_out_act`` raises JAX's error for it;
- ``GANStandardGenerator`` (8-down pix2pix), ``GANShortNoShortCutGenerator``
  (no skips), ``GANShortGeneratorVAE`` with ``VariationNet`` (which samples
  its latent from the caller's ``torch.Generator``, where JAX takes a PRNG
  key and the reference numpy's global RNG, src/model.py:1659);
- ``LowdoseModel`` (residual U-Net, Tanh correction added to input channel
  0; its upsampling uses ``align_corners=False``);
- ``SymmetrySpatialAttentionLayer`` (and its ``residual`` variant,
  src/model.py:1359) and ``MultiAttentionLayer``, whose channel counts are
  divided as integers (the reference's float division crashes,
  src/model.py:1441).

Block activations go through quirk Q1 (``resolve_block_act``).  The
symmetry gates flip along H, dim 2 of NCHW (JAX axis -3 of NHWC).

Parameter names: the Conv_BN_Act / Act_Deconv_BN_Concat generators carry
the reference's (``down_1.0``, ``down_i.conv.0`` / ``.conv.1``,
``up_i.up.1``, ``up_i.bn``, ``output.up.1``), the attention layers
``W_x``, ``W_g``, ``W_psi``, ``W_out.0`` / ``W_out.1``.  ``UNet`` and
``LowdoseModel`` have no reference names in the repository, so they carry
the JAX module names (``down_1.conv0``, ``up_4_conv``, ``conv1_c0``,
``conv1_bn0``, ...).  Every train-mode BatchNorm here is one group (G = 1).

Top-level models take ``gen`` (a ``torch.Generator`` for torch's default
init; seeded 0 when absent) and ``device`` (CUDA when absent; raises
without a card).  ``weights.from_jax_legacy`` carries JAX parameters over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.attention import (
    out_conv_bn)
from representation_disentanglement_torch.models.layers import (
    ActDeconvBNConcat, BatchNormTorch, ConvBNAct, MaybeCondConv,
    resolve_device)
from representation_disentanglement_torch.ops import (
    apply_act, avg_pool, bilinear_resize, max_pool)


def _out_act(name: str) -> str:
    if name == "linear":
        raise ValueError(
            "output_activation='linear' crashes in the reference "
            "(nn.Linear() without args, src/model.py:96); use 'no'")
    if name in ("sigmoid", "tanh", "no"):
        return name
    return "softplus"


def default_gen(gen: Optional[torch.Generator]) -> torch.Generator:
    return gen if gen is not None else torch.Generator().manual_seed(0)


def up2x(x, align_corners: bool = True):
    return bilinear_resize(x, (2 * x.shape[-2], 2 * x.shape[-1]),
                           align_corners=align_corners)


class ConvDoubleBlock(nn.Module):
    """(conv3x3 -> BN -> ReLU) twice: ``conv0``, ``bn0``, ``conv1``,
    ``bn1`` (JAX's ``is_bn`` field is never off)."""

    def __init__(self, in_ch: int, features: int, *, gen: torch.Generator):
        super().__init__()
        for i in range(2):
            setattr(self, f"conv{i}", MaybeCondConv(
                in_ch if i == 0 else features, features, 3, 1, 1, gen=gen))
            setattr(self, f"bn{i}", BatchNormTorch(features))

    def forward(self, x):
        for i in range(2):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class UNet(nn.Module):
    """Plain U-Net (src/model.py:76-112): maxpool downs, real ReLUs."""

    def __init__(self, in_ch: int, out_num_ch: int, first_num_ch: int = 64,
                 output_activation: str = "softplus", *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen, f = default_gen(gen), first_num_ch
        self.out_act = _out_act(output_activation)
        chans = [f, 2 * f, 4 * f, 8 * f, 16 * f]
        prev = in_ch
        for i, ch in enumerate(chans, start=1):
            setattr(self, f"down_{i}", ConvDoubleBlock(prev, ch, gen=gen))
            prev = ch
        for i, ch in zip((4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f)):
            setattr(self, f"up_{i}_conv",
                    MaybeCondConv(prev, ch, 3, 1, 1, gen=gen))
            setattr(self, f"up_{i}_block",
                    ConvDoubleBlock(2 * ch, ch, gen=gen))
            prev = ch
        self.output = MaybeCondConv(f, out_num_ch, 1, 1, 0, gen=gen)
        self.to(resolve_device(device))

    def forward(self, x):
        """x: [B, C, H, W] -> (y [B, out, H, W], {})."""
        downs = [self.down_1(x)]
        for i in range(2, 6):
            downs.append(getattr(self, f"down_{i}")(max_pool(downs[-1], 2)))
        up = downs[4]
        for i in (4, 3, 2, 1):
            u = getattr(self, f"up_{i}_conv")(up2x(up))
            up = getattr(self, f"up_{i}_block")(
                torch.cat([downs[i - 1], u], dim=1))
        return apply_act(self.output(up), self.out_act), {}


def _conv_bn_act_downs(m: nn.Module, in_ch: int, chans, gen,
                       fix_act_bug: bool) -> None:
    """``down_1`` (conv + LeakyReLU, ``down_1.0``) and Conv_BN_Act blocks
    ``down_2`` .. with ``chans`` features, the last without activation."""
    m.down_1 = nn.ModuleList([MaybeCondConv(in_ch, chans[0], 4, 2, 1,
                                            gen=gen)])
    for i, ch in enumerate(chans[1:], start=2):
        act = "no" if i == len(chans) else "lrelu"
        setattr(m, f"down_{i}", ConvBNAct(
            chans[i - 2], ch, gen=gen, activation=act,
            fix_act_bug=fix_act_bug, style="old"))
    m.n_downs = len(chans)


def _run_downs(m: nn.Module, x):
    downs = [F.leaky_relu(m.down_1[0](x), 0.2)]
    for i in range(2, m.n_downs + 1):
        downs.append(getattr(m, f"down_{i}")(downs[-1]))
    return downs


class GANStandardGenerator(nn.Module):
    """8-down pix2pix generator (src/model.py:209-259)."""

    def __init__(self, in_ch: int, out_num_ch: int, first_num_ch: int = 64,
                 output_activation: str = "softplus",
                 fix_act_bug: bool = False, *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen, f = default_gen(gen), first_num_ch
        self.out_act = _out_act(output_activation)
        _conv_bn_act_downs(self, in_ch, [f, 2 * f, 4 * f] + [8 * f] * 5,
                           gen, fix_act_bug)
        _standard_ups(self, f, out_num_ch, gen, fix_act_bug)
        self.to(resolve_device(device))

    def forward(self, x):
        """x: [B, C, H, W] (H, W divisible by 256) -> (y, {})."""
        return apply_act(_run_standard_ups(self, _run_downs(self, x)),
                         self.out_act), {}


def _standard_ups(m: nn.Module, f: int, out_num_ch: int, gen,
                  fix_act_bug: bool) -> None:
    """``up_7`` .. ``up_1`` and ``output`` of the 8-down generators."""
    kw = dict(gen=gen, fix_act_bug=fix_act_bug, style="old")
    prev = 8 * f
    for i, ch in zip(range(7, 0, -1), [8 * f] * 4 + [4 * f, 2 * f, f]):
        setattr(m, f"up_{i}", ActDeconvBNConcat(prev, ch, **kw))
        prev = 2 * ch
    m.output = ActDeconvBNConcat(prev, out_num_ch, is_last=True, **kw)


def _run_standard_ups(m: nn.Module, downs):
    up = downs[-1]
    for i in range(7, 0, -1):
        up = getattr(m, f"up_{i}")(downs[i - 1], up)
    return m.output(None, up)


class _ActDeconvBN(nn.Module):
    """Act_Deconv_BN (src/model.py:176-207): the quirk-Q1 identity, x2
    bilinear (align_corners=True), conv3x3 ``up.1`` and, with ``is_bn``,
    ``bn``."""

    def __init__(self, in_ch: int, features: int, *, gen: torch.Generator,
                 is_bn: bool = True):
        super().__init__()
        self.up = nn.ModuleList([nn.Identity(), MaybeCondConv(
            in_ch, features, 3, 1, 1, gen=gen)])
        self.bn = BatchNormTorch(features) if is_bn else None

    def forward(self, x):
        y = self.up[1](up2x(x))
        return y if self.bn is None else self.bn(y)


class GANShortNoShortCutGenerator(nn.Module):
    """Short U-Net without skip connections (src/model.py:301-339)."""

    def __init__(self, in_ch: int, out_num_ch: int, first_num_ch: int = 64,
                 output_activation: str = "softplus",
                 fix_act_bug: bool = False, *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen, f = default_gen(gen), first_num_ch
        self.out_act = _out_act(output_activation)
        _conv_bn_act_downs(self, in_ch, [f, 2 * f, 4 * f, 8 * f, 8 * f],
                           gen, fix_act_bug)
        prev = 8 * f
        for i, ch in zip((4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f)):
            setattr(self, f"up_{i}", _ActDeconvBN(prev, ch, gen=gen))
            prev = ch
        self.output = _ActDeconvBN(f, out_num_ch, gen=gen, is_bn=False)
        self.to(resolve_device(device))

    def forward(self, x):
        h = _run_downs(self, x)[-1]
        for i in (4, 3, 2, 1):
            h = getattr(self, f"up_{i}")(h)
        return apply_act(self.output(h), self.out_act), {}


class VariationNet(nn.Module):
    """Encoder to a spatial latent [B, 8f, H/32, W/32] with unit-variance
    sampling (src/model.py:1648-1684): with a ``generator`` the latent
    gets standard normal noise drawn from it in f32."""

    def __init__(self, in_ch: int, first_num_ch: int = 64,
                 fix_act_bug: bool = False, *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen, f = default_gen(gen), first_num_ch
        _conv_bn_act_downs(self, in_ch, [f, 2 * f, 4 * f, 8 * f, 8 * f],
                           gen, fix_act_bug)
        self.to(resolve_device(device))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = _run_downs(self, x)[-1]
        if generator is not None:                 # LatentLayer sampling
            h = h + torch.randn(h.shape, generator=generator,
                                device=h.device).to(h.dtype)
        return h


class GANShortGeneratorVAE(nn.Module):
    """Short U-Net with a latent [B, latent_ch, H/32, W/32] concatenated at
    the bottleneck (src/model.py:1606-1645); ``latent_ch`` defaults to
    VariationNet's 8 * first_num_ch."""

    def __init__(self, in_ch: int, out_num_ch: int, first_num_ch: int = 64,
                 output_activation: str = "softplus",
                 fix_act_bug: bool = False,
                 latent_ch: Optional[int] = None, *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen, f = default_gen(gen), first_num_ch
        self.out_act = _out_act(output_activation)
        _conv_bn_act_downs(self, in_ch, [f, 2 * f, 4 * f, 8 * f, 8 * f],
                           gen, fix_act_bug)
        kw = dict(gen=gen, fix_act_bug=fix_act_bug, style="old")
        lat = 8 * f if latent_ch is None else latent_ch
        self.up_4 = ActDeconvBNConcat(8 * f + lat, 8 * f, **kw)
        self.up_3 = ActDeconvBNConcat(16 * f, 4 * f, **kw)
        self.up_2 = ActDeconvBNConcat(8 * f, 2 * f, **kw)
        self.up_1 = ActDeconvBNConcat(4 * f, f, **kw)
        self.output = ActDeconvBNConcat(2 * f, out_num_ch, is_last=True,
                                        **kw)
        self.to(resolve_device(device))

    def forward(self, x, latent):
        d1, d2, d3, d4, d5 = _run_downs(self, x)
        u = self.up_4(d4, torch.cat([d5, latent], dim=1))
        u = self.up_3(d3, u)
        u = self.up_2(d2, u)
        u = self.up_1(d1, u)
        return apply_act(self.output(None, u), self.out_act), {}


class LowdoseModel(nn.Module):
    """Residual U-Net, Tanh correction added to input channel 0
    (src/model.py:2803-2898).  Blocks of three conv3x3 -> BN -> ReLU
    (``{block}_c{i}``, ``{block}_bn{i}``) at 32, 32, 64, 64 channels down
    and 64, 32, 32 up, maxpool downs, x2 bilinear ups with
    align_corners=False, and ``dconv1_out`` (32 -> 1)."""

    BLOCKS = (("conv1", 32), ("conv2", 32), ("conv3", 64), ("conv4", 64),
              ("dconv3", 64), ("dconv2", 32), ("dconv1", 32))

    def __init__(self, in_ch: int, *, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        gen = default_gen(gen)
        ins = {"conv1": in_ch, "conv2": 32, "conv3": 32, "conv4": 64,
               "dconv3": 128, "dconv2": 96, "dconv1": 64}
        for name, ch in self.BLOCKS:
            for i in range(3):
                setattr(self, f"{name}_c{i}", MaybeCondConv(
                    ins[name] if i == 0 else ch, ch, 3, 1, 1, gen=gen))
                setattr(self, f"{name}_bn{i}", BatchNormTorch(ch))
        self.dconv1_out = MaybeCondConv(32, 1, 3, 1, 1, gen=gen)
        self.to(resolve_device(device))

    def _triple(self, h, name):
        for i in range(3):
            h = F.relu(getattr(self, f"{name}_bn{i}")(
                getattr(self, f"{name}_c{i}")(h)))
        return h

    def forward(self, x):
        """x: [B, C, H, W] -> (x[:, :1] + tanh(correction), None)."""
        up = lambda h: up2x(h, align_corners=False)
        c1 = self._triple(x, "conv1")
        c2 = self._triple(max_pool(c1, 2), "conv2")
        c3 = self._triple(max_pool(c2, 2), "conv3")
        bott = max_pool(c3, 2)
        c4 = self._triple(bott, "conv4")
        d3 = self._triple(torch.cat([up(c4 + bott), c3], 1), "dconv3")
        d2 = self._triple(torch.cat([up(d3), c2], 1), "dconv2")
        h = self._triple(torch.cat([up(d2), c1], 1), "dconv1")
        return x[:, 0:1] + torch.tanh(self.dconv1_out(h)), None


class SymmetrySpatialAttentionLayer(nn.Module):
    """Gate from |g - flip_H(g)| (src/model.py:1329-1357): output
    ``W_out`` of alpha * x, or of (1 + alpha) * x with ``residual``
    (SymmetryResidualSpatialAttentionLayer, src/model.py:1359)."""

    def __init__(self, in_ch: int, gate_ch: int, inter_num_ch: int, *,
                 gen: torch.Generator, sample_factor=(2, 2),
                 residual: bool = False):
        super().__init__()
        self.residual = residual
        self.W_x = MaybeCondConv(in_ch, inter_num_ch, sample_factor,
                                 sample_factor, 0, gen=gen, bias=False)
        self.W_g = MaybeCondConv(gate_ch, inter_num_ch, 1, 1, 0, gen=gen)
        self.W_psi = MaybeCondConv(inter_num_ch, 1, 1, 1, 0, gen=gen)
        self.W_out = nn.ModuleList([
            MaybeCondConv(in_ch, in_ch, 1, 1, 0, gen=gen),
            BatchNormTorch(in_ch)])

    def forward(self, x, g, groups: int = 1):
        x_post = self.W_x(x)
        g_diff = (g - torch.flip(g, dims=[2])).abs()
        g_post = bilinear_resize(self.W_g(g_diff), x_post.shape[-2:],
                                 align_corners=False)
        alpha = torch.sigmoid(self.W_psi(F.relu(x_post + g_post)))
        alpha_up = bilinear_resize(alpha, x.shape[-2:], align_corners=False)
        gate = 1.0 + alpha_up if self.residual else alpha_up
        return out_conv_bn(self.W_out, gate * x, groups), alpha_up


class MultiAttentionLayer(nn.Module):
    """Spatially pooled channel attention over x and the flip difference of
    g (src/model.py:1435-1467): ``W_x``, ``W_g`` (in_ch), ``W_down``
    (in_ch // sample_factor_channel), ``W_up`` and ``W_out`` (``.0`` /
    ``.1``; the conv alone without ``is_bn``)."""

    def __init__(self, in_ch: int, gate_ch: int, *, gen: torch.Generator,
                 sample_factor_spatial: Tuple[int, int] = (2, 2),
                 sample_factor_channel: int = 16,
                 kernel_stride_ratio: int = 4, is_bn: bool = True):
        super().__init__()
        self.stride = tuple(sample_factor_spatial)
        self.kernel = tuple(s * kernel_stride_ratio for s in self.stride)
        mid = in_ch // sample_factor_channel
        self.W_x = MaybeCondConv(in_ch, in_ch, 1, 1, 0, gen=gen)
        self.W_g = MaybeCondConv(gate_ch, in_ch, 1, 1, 0, gen=gen)
        self.W_down = MaybeCondConv(in_ch, mid, 1, 1, 0, gen=gen)
        self.W_up = MaybeCondConv(mid, in_ch, 1, 1, 0, gen=gen)
        out = MaybeCondConv(in_ch, in_ch, 1, 1, 0, gen=gen)
        self.W_out = (nn.ModuleList([out, BatchNormTorch(in_ch)]) if is_bn
                      else out)

    def forward(self, x, g, groups: int = 1):
        g_post = bilinear_resize(self.W_g(g - torch.flip(g, dims=[2])),
                                 x.shape[-2:], align_corners=False)
        xg = F.relu(self.W_x(x) + g_post)
        down = F.relu(self.W_down(avg_pool(xg, self.kernel, self.stride)))
        alpha = torch.sigmoid(self.W_up(down))
        alpha_up = bilinear_resize(alpha, x.shape[-2:], align_corners=False)
        return (out_conv_bn(self.W_out, (1.0 + alpha_up) * x, groups),
                alpha_up)
