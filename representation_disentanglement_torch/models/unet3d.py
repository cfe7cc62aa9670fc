"""Volumetric stack: the Myronenko-style 3D U-Net with its VAE
regularization branch (JAX ``models/unet3d.py``; reference ``BasicBlock`` /
``VAEBranch`` / ``UNet3D`` / ``NVNet3D``, src/model.py:1856-2060).

Layout ``[B, C, H, W, D]``, kernels ``(O, I, kH, kW, kD)`` and parameter
names are the reference torch model's (``unet.conv1a``,
``unet.conv1b.gn1``, ..., ``vae_branch.hidden_conv.{0,2}``,
``vae_branch.reconstraction.0`` (sic), ``vae_branch.vconv3.{0,2}``, ...,
``vae_branch.vconv0``), so a reference ``state_dict`` loads as it is;
``weights.from_jax_nvnet3d`` carries JAX parameters over.

Initialization is torch's default from an explicit ``torch.Generator``:
U(+-1/sqrt(fan_in)) for conv and linear weights and biases, GroupNorm scale
1 and bias 0.  Randomness in training comes from the caller's generator:
dropout on ``c4d`` (elementwise, keep 0.8) and the VAE's
``z = mu + eps * exp(logvar / 2)``.  Without a generator training is
deterministic (``z = mu``, no dropout), as JAX's ``rng=None``; in eval
``z = mu`` (the reference samples in eval too, the JAX package does not).

The reference's ``BasicBlock`` sizes its second GroupNorm for
``in_channels`` (src/model.py:1862), consistent only because every block
has in == out, which ``BasicBlock3D`` asserts.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from representation_disentanglement_torch.models.layers import (
    TorchLinear, _uniform)
from representation_disentanglement_torch.ops.conv3d import (
    conv3d, global_mean3d, group_norm, upsample3d_nearest)


class Conv3d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, *,
                 gen: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(in_ch * kernel_size ** 3)
        self.weight = _uniform((out_ch, in_ch) + (kernel_size,) * 3, bound,
                               gen)
        self.bias = _uniform((out_ch,), bound, gen)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return conv3d(x, self.weight, self.bias, self.stride, self.padding)


class GroupNorm(nn.Module):
    def __init__(self, features: int, num_groups: int = 8):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.num_groups = num_groups

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups)


class Upsample3d(nn.Module):
    def forward(self, x):
        return upsample3d_nearest(x)


class BasicBlock3D(nn.Module):
    """Pre-activation residual block (src/model.py:1856-1875)."""

    def __init__(self, in_ch: int, out_ch: int, *, gen: torch.Generator):
        super().__init__()
        assert in_ch == out_ch, (
            "reference BasicBlock requires in_channels == out_channels "
            "(its gn2 is sized for in_channels, src/model.py:1862)")
        self.gn1 = GroupNorm(in_ch)
        self.conv1 = Conv3d(in_ch, out_ch, gen=gen)
        self.gn2 = GroupNorm(in_ch)
        self.conv2 = Conv3d(out_ch, out_ch, gen=gen)

    def forward(self, x):
        h = self.conv1(torch.relu(self.gn1(x)))
        return self.conv2(torch.relu(self.gn2(h))) + x


class UNet3D(nn.Module):
    """src/model.py:1952-2047."""

    def __init__(self, in_channels: int = 4, out_channels: int = 3,
                 init_channels: int = 32, dropout_p: float = 0.2, *,
                 gen: torch.Generator):
        super().__init__()
        f = init_channels
        self.dropout_p = dropout_p
        conv = lambda i, o, **kw: Conv3d(i, o, gen=gen, **kw)
        block = lambda c: BasicBlock3D(c, c, gen=gen)
        self.conv1a = conv(in_channels, f)
        self.conv1b = block(f)
        self.ds1 = conv(f, 2 * f, stride=2)
        self.conv2a = block(2 * f)
        self.conv2b = block(2 * f)
        self.ds2 = conv(2 * f, 4 * f, stride=2)
        self.conv3a = block(4 * f)
        self.conv3b = block(4 * f)
        self.ds3 = conv(4 * f, 8 * f, stride=2)
        self.conv4a = block(8 * f)
        self.conv4b = block(8 * f)
        self.conv4c = block(8 * f)
        self.conv4d = block(8 * f)
        self.up4conva = conv(8 * f, 4 * f, kernel_size=1, padding=0)
        self.up4convb = block(4 * f)
        self.up3conva = conv(4 * f, 2 * f, kernel_size=1, padding=0)
        self.up3convb = block(2 * f)
        self.up2conva = conv(2 * f, f, kernel_size=1, padding=0)
        self.up2convb = block(f)
        self.up1conv = conv(f, out_channels, kernel_size=1, padding=0)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        c1 = self.conv1b(self.conv1a(x))
        c2 = self.conv2b(self.conv2a(self.ds1(c1)))
        c3 = self.conv3b(self.conv3a(self.ds2(c2)))
        c4d = self.conv4d(self.conv4c(self.conv4b(self.conv4a(
            self.ds3(c3)))))
        if self.training and self.dropout_p > 0 and generator is not None:
            keep = 1.0 - self.dropout_p
            mask = torch.empty_like(c4d).bernoulli_(keep, generator=generator)
            c4d = torch.where(mask.bool(), c4d / keep, 0.0)
        u4 = self.up4convb(upsample3d_nearest(self.up4conva(c4d)) + c3)
        u3 = self.up3convb(upsample3d_nearest(self.up3conva(u4)) + c2)
        u2 = self.up2convb(upsample3d_nearest(self.up2conva(u3)) + c1)
        return self.up1conv(u2), c4d


class VAEBranch(nn.Module):
    """src/model.py:1878-1949.  ``input_shape`` is (H, W, D) of the
    volume."""

    def __init__(self, input_shape: Tuple[int, int, int],
                 init_channels: int = 16, out_channels: int = 4,
                 squeeze_channels: Optional[int] = None, *,
                 gen: torch.Generator):
        super().__init__()
        f = init_channels
        sq = squeeze_channels or f * 4
        self.f, self.sq = f, sq
        self.d16 = tuple(s // 16 for s in input_shape)
        conv = lambda i, o, **kw: Conv3d(i, o, gen=gen, **kw)
        self.hidden_conv = nn.Sequential(GroupNorm(8 * f), nn.ReLU(),
                                         conv(8 * f, sq))
        self.mu_fc = TorchLinear(sq // 2, sq // 2, gen)
        self.logvar_fc = TorchLinear(sq // 2, sq // 2, gen)
        self.reconstraction = nn.Sequential(
            TorchLinear(sq // 2, 8 * f * math.prod(self.d16), gen), nn.ReLU())
        self.vconv4 = nn.Sequential(
            conv(8 * f, 8 * f, kernel_size=1, padding=0), Upsample3d())
        self.vconv3 = nn.Sequential(conv(8 * f, 4 * f), Upsample3d(),
                                    BasicBlock3D(4 * f, 4 * f, gen=gen))
        self.vconv2 = nn.Sequential(conv(4 * f, 2 * f), Upsample3d(),
                                    BasicBlock3D(2 * f, 2 * f, gen=gen))
        self.vconv1 = nn.Sequential(conv(2 * f, f), Upsample3d(),
                                    BasicBlock3D(f, f, gen=gen))
        self.vconv0 = conv(f, out_channels, kernel_size=1, padding=0)

    def forward(self, c4d, generator: Optional[torch.Generator] = None):
        h = global_mean3d(self.hidden_conv(c4d))        # AdaptiveAvgPool(1)
        half = self.sq // 2
        mu = self.mu_fc(h[:, :half])
        logvar = self.logvar_fc(h[:, half:])
        z = mu
        if self.training and generator is not None:
            eps = torch.empty_like(mu).normal_(generator=generator)
            z = mu + eps * torch.exp(0.5 * logvar)
        re = self.reconstraction(z).view(-1, 8 * self.f, *self.d16)
        v = self.vconv1(self.vconv2(self.vconv3(self.vconv4(re))))
        return self.vconv0(v), mu, logvar


class NVNet3D(nn.Module):
    """src/model.py:2050-2060: the U-Net's segmentation plus the VAE
    branch's reconstruction of the input."""

    def __init__(self, input_shape: Tuple[int, int, int] = (160, 192, 64),
                 in_channels: int = 4, out_channels: int = 3,
                 init_channels: int = 16, dropout_p: float = 0.2, *,
                 gen: torch.Generator):
        super().__init__()
        if any(s % 16 for s in input_shape):
            raise ValueError(f"input_shape {tuple(input_shape)} (H, W, D) "
                             "must divide by 16 (the VAE decodes from /16)")
        self.unet = UNet3D(in_channels, out_channels, init_channels,
                           dropout_p, gen=gen)
        self.vae_branch = VAEBranch(input_shape, init_channels,
                                    out_channels=in_channels, gen=gen)

    @property
    def device(self) -> torch.device:
        return self.unet.conv1a.weight.device

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x [B, M, H, W, D] -> (uout [B, 3, H, W, D] logits, vout [B, M, H,
        W, D], mu, logvar [B, squeeze / 2]).  ``generator`` draws the
        dropout mask, then the VAE's eps, in train mode only."""
        uout, c4d = self.unet(x, generator)
        vout, mu, logvar = self.vae_branch(c4d, generator)
        return uout, vout, mu, logvar


def build_nvnet3d(input_shape: Tuple[int, int, int] = (160, 192, 64),
                  in_channels: int = 4, out_channels: int = 3,
                  init_channels: int = 16, dropout_p: float = 0.2,
                  device=None, generator: Optional[torch.Generator] = None
                  ) -> NVNet3D:
    """NVNet3D initialized from ``generator`` (default: a CPU generator
    seeded with 10, the JAX entry point's init key) on ``device`` (default:
    CUDA), in eval mode."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the port on the CPU")
        device = "cuda"
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(10)
    model = NVNet3D(input_shape, in_channels, out_channels, init_channels,
                    dropout_p, gen=gen)
    return model.to(device).eval()


def nvnet_loss(uout, vout, mu, logvar, seg_target, x_input,
               kl_weight: float = 0.1, recon_weight: float = 0.1):
    """The Myronenko NVNet loss, in f32: 3-class soft Dice on
    ``sigmoid(uout)`` (eps 1e-6) + ``recon_weight`` * mean squared VAE
    reconstruction error + ``kl_weight`` * KL, the KL summed over z, meaned
    over the batch and divided by one sample's voxels times contrasts.

    ``seg_target`` [B, 1, H, W, D] holds labels 0-3; channel i of ``uout``
    scores class i + 1.  Returns (loss, {"dice_loss", "vae_recon", "kl"})."""
    p = torch.sigmoid(uout.float())
    seg = seg_target[:, 0]
    dice = 0.0
    for i in range(uout.shape[1]):
        gt = (seg == i + 1).float()
        num = 2.0 * torch.sum(p[:, i] * gt)
        den = torch.sum(torch.square(p[:, i]) + torch.square(gt))
        dice = dice + (1.0 - num / (den + 1e-6))
    dice = dice / uout.shape[1]
    n = x_input[0].numel()
    recon = torch.mean(torch.square(vout.float() - x_input.float()))
    lv, m = logvar.float(), mu.float()
    kl = torch.mean(torch.sum(torch.exp(lv) + torch.square(m) - 1.0 - lv,
                              dim=-1)) / n
    return dice + recon_weight * recon + kl_weight * kl, {
        "dice_loss": dice, "vae_recon": recon, "kl": kl}
