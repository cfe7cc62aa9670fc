"""DANet, the dual-attention segmentation net (JAX ``models/danet.py``;
reference src/model.py:1695-1853).

The reference's DANet cannot be built (its ``BackBone`` names an undefined
``resnet`` module, src/model.py:1767), so this is, as in the JAX package,
the network the code intends:

- ``PAM`` (position attention): a (HW) x (HW) softmax attention over the
  positions, products and softmax in f32, the result cast back to x's
  dtype; positions flatten row-major (h, w), the order of JAX's NHWC
  reshape;
- ``CAM`` (channel attention): a C x C gram attention with the
  max-minus-energy trick, in f32;
- ``BackBone``: a dilated ResNet50 in torch-encoding's configuration
  (layer3 dilation 2, layer4 stride 1 with per-block dilations 4/8/16,
  output stride 8), with torch-encoding's parameter names (``conv1``,
  ``bn1``, ``layer{l}.{b}.conv1`` .. ``.bn3``, ``.downsample.0/1``);
- ``DANetHead``: ``conv5a`` / ``conv5c`` / ``conv51`` / ``conv52`` (conv3x3
  ``.0``, BN ``.1``, ReLU), ``sa`` (PAM), ``sc`` (CAM), and the 1x1 heads
  ``conv6`` / ``conv7`` / ``conv8`` (``.1``, behind Dropout2d(0.1), which
  draws from the caller's ``torch.Generator`` in train mode; without one
  there is no dropout, as JAX without an rng);
- ``DANet``: x2 bilinear upsample (align_corners=True), the 3-channel
  ``input_conv`` + ReLU, the backbone, the head, and the main output
  resized back to the input size.

``gamma`` of PAM and CAM starts at zero, as in the reference.  A bf16 x
stays bf16 through the attention modules' residual sum, where JAX promotes
it to f32 with the f32 ``gamma``.  Every train-mode BatchNorm is one group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.layers import (
    BatchNormTorch, MaybeCondConv, resolve_device)
from representation_disentanglement_torch.models.legacy import default_gen
from representation_disentanglement_torch.ops import bilinear_resize


class PAM(nn.Module):
    """Position attention (src/model.py:1695-1728)."""

    def __init__(self, in_dim: int, *, gen: torch.Generator):
        super().__init__()
        self.query_conv = MaybeCondConv(in_dim, in_dim // 8, 1, gen=gen)
        self.key_conv = MaybeCondConv(in_dim, in_dim // 8, 1, gen=gen)
        self.value_conv = MaybeCondConv(in_dim, in_dim, 1, gen=gen)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, c, h, w = x.shape
        q = self.query_conv(x).flatten(2).float()          # [B, C/8, HW]
        k = self.key_conv(x).flatten(2).float()
        v = self.value_conv(x).flatten(2).float()          # [B, C, HW]
        attn = torch.softmax(torch.bmm(q.transpose(1, 2), k), dim=-1)
        out = torch.bmm(v, attn.transpose(1, 2)).reshape(b, c, h, w)
        return self.gamma.to(x.dtype) * out.to(x.dtype) + x


class CAM(nn.Module):
    """Channel attention (src/model.py:1731-1760)."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, c, h, w = x.shape
        f = x.flatten(2).float()                           # [B, C, HW]
        energy = torch.bmm(f, f.transpose(1, 2))           # [B, C, C]
        energy = energy.amax(dim=-1, keepdim=True) - energy
        out = torch.bmm(torch.softmax(energy, dim=-1), f).reshape(b, c, h, w)
        return self.gamma.to(x.dtype) * out.to(x.dtype) + x


class Bottleneck(nn.Module):
    """ResNet bottleneck with a dilated 3x3 (padding = dilation)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, *, gen: torch.Generator):
        super().__init__()
        p = planes
        self.conv1 = MaybeCondConv(in_ch, p, 1, gen=gen, bias=False)
        self.bn1 = BatchNormTorch(p)
        self.conv2 = MaybeCondConv(p, p, 3, stride, dilation, gen=gen,
                                   bias=False, dilation=dilation)
        self.bn2 = BatchNormTorch(p)
        self.conv3 = MaybeCondConv(p, 4 * p, 1, gen=gen, bias=False)
        self.bn3 = BatchNormTorch(4 * p)
        self.downsample = None
        if stride != 1 or in_ch != 4 * p:
            self.downsample = nn.Sequential(
                MaybeCondConv(in_ch, 4 * p, 1, stride, gen=gen, bias=False),
                BatchNormTorch(4 * p))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(h + x)


class BackBone(nn.Module):
    """Dilated ResNet50, output stride 8: x [B, 3, H, W] -> [B, 2048, H/8,
    W/8]."""

    # (planes, blocks, stride of the first block, dilations per block)
    LAYERS = ((64, 3, 1, None), (128, 4, 2, None), (256, 6, 1, (2,) * 6))

    def __init__(self, in_ch: int = 3, multi_dilation=(4, 8, 16), *,
                 gen: torch.Generator):
        super().__init__()
        self.conv1 = MaybeCondConv(in_ch, 64, 7, 2, 3, gen=gen, bias=False)
        self.bn1 = BatchNormTorch(64)
        prev = 64
        layers = self.LAYERS + ((512, 3, 1, tuple(multi_dilation)),)
        for li, (p, nblk, s, dil) in enumerate(layers, start=1):
            blocks = []
            for b in range(nblk):
                blocks.append(Bottleneck(prev, p, s if b == 0 else 1,
                                         dil[b] if dil else 1, gen=gen))
                prev = 4 * p
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for li in range(1, 5):
            h = getattr(self, f"layer{li}")(h)
        return h


def _conv_bn_relu(in_ch: int, out_ch: int, gen) -> nn.Sequential:
    return nn.Sequential(MaybeCondConv(in_ch, out_ch, 3, 1, 1, gen=gen,
                                       bias=False),
                         BatchNormTorch(out_ch), nn.ReLU())


class DANetHead(nn.Module):
    """src/model.py:1780-1825: x [B, C, h, w] -> (sasc, sa, sc) outputs of
    ``out_num_ch`` channels."""

    def __init__(self, in_channels: int, out_num_ch: int, *,
                 gen: torch.Generator):
        super().__init__()
        inter = in_channels // 4
        self.conv5a = _conv_bn_relu(in_channels, inter, gen)
        self.conv5c = _conv_bn_relu(in_channels, inter, gen)
        self.sa = PAM(inter, gen=gen)
        self.sc = CAM()
        self.conv51 = _conv_bn_relu(inter, inter, gen)
        self.conv52 = _conv_bn_relu(inter, inter, gen)
        for name in ("conv6", "conv7", "conv8"):
            setattr(self, name, nn.ModuleList([
                nn.Identity(), MaybeCondConv(inter, out_num_ch, 1, gen=gen)]))

    def _head(self, h, name: str, generator):
        if self.training and generator is not None:   # Dropout2d(0.1)
            keep = torch.rand((h.shape[0], h.shape[1], 1, 1),
                              generator=generator, device=h.device) < 0.9
            h = h * keep.to(h.dtype) / 0.9
        return getattr(self, name)[1](h)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        sa_conv = self.conv51(self.sa(self.conv5a(x)))
        sc_conv = self.conv52(self.sc(self.conv5c(x)))
        return (self._head(sa_conv + sc_conv, "conv8", generator),
                self._head(sa_conv, "conv6", generator),
                self._head(sc_conv, "conv7", generator))


class DANet(nn.Module):
    """src/model.py:1827-1853: x [B, in_ch, H, W] -> (y [B, out, H, W],
    [])."""

    def __init__(self, in_ch: int, out_num_ch: int, *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen = default_gen(gen)
        self.input_conv = MaybeCondConv(in_ch, 3, 3, 1, 1, gen=gen)
        self.backbone = BackBone(3, gen=gen)
        self.head = DANetHead(2048, out_num_ch, gen=gen)
        self.to(resolve_device(device))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        size = x.shape[-2:]
        h = bilinear_resize(x, (2 * size[0], 2 * size[1]),
                            align_corners=True)
        h = F.relu(self.input_conv(h))
        out = self.head(self.backbone(h), generator)[0]
        return bilinear_resize(out, size, align_corners=True), []
