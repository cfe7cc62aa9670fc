"""The anatomy-code discriminator and the learned z prior (JAX
models/discriminator.py; reference ``Discriminator``, src/model.py:
2769-2800, and ``ModalityDistribution``, src/model.py:2902-2914).

Parameter names are the reference torch model's: ``discrim.{0,2,5,8,11}``
for the five 4x4 stride-2 convs, ``discrim.{3,6,9,12}`` for the BatchNorms
of stages 2-5 (the LeakyReLUs sit at the indices between), ``fc.{1,3}``
for the critic's two linears; ``linear.{0,2}`` for the prior's.

The discriminator flattens its last feature map in NCHW order (C, H, W),
the torch reference's, so ``fc.1`` needs no permutation here
(``weights.from_jax_params`` undoes the JAX package's HWC order).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.layers import (
    BatchNormTorch, MaybeCondConv, TorchLinear)

_SLOPE = 0.2


class Discriminator(nn.Module):
    """Five conv stages (16, 32, 64, 128, 64 channels at inter_num_ch 16),
    BatchNorm on stages 2-5, LeakyReLU 0.2, then fc 64·(H/32)·(W/32) ->
    16·inter_num_ch -> LeakyReLU -> 1.

    ``forward(x, groups)``: x [G*B, C, H, W], group-major.  In train mode
    each BatchNorm normalizes each of the G groups with its own batch
    statistics and applies G ordered running-stat updates, as the JAX
    package's grouped BatchNorm does.  Returns logits [G*B, 1]."""

    CONV_IDX = (0, 2, 5, 8, 11)

    def __init__(self, in_ch: int, input_size, *, gen: torch.Generator,
                 inter_num_ch: int = 16):
        super().__init__()
        f = inter_num_ch
        chans = (f, 2 * f, 4 * f, 8 * f, 4 * f)
        layers, prev = [], in_ch
        for i, ch in enumerate(chans):
            layers.append(MaybeCondConv(prev, ch, 4, 2, 1, gen=gen))
            if i > 0:
                layers.append(BatchNormTorch(ch))
            layers.append(nn.LeakyReLU(_SLOPE))
            prev = ch
        self.discrim = nn.Sequential(*layers)
        flat = chans[-1] * (input_size[0] // 32) * (input_size[1] // 32)
        self.fc = nn.Sequential(nn.Flatten(), TorchLinear(flat, 16 * f, gen),
                                nn.LeakyReLU(_SLOPE),
                                TorchLinear(16 * f, 1, gen))

    def forward(self, x, groups: int = 1):
        for layer in self.discrim:
            if isinstance(layer, BatchNormTorch):
                x = layer(x, groups)
            elif isinstance(layer, nn.LeakyReLU):
                x = F.leaky_relu(x, _SLOPE)
            else:
                x = layer(x)
        h = F.leaky_relu(self.fc[1](x.reshape(x.shape[0], -1)), _SLOPE)
        return self.fc[3](h)


class ModalityDistribution(nn.Module):
    """Per-modality-label MLP: label [M, 1] -> 128 -> LeakyReLU 0.2 -> 2z,
    split into the prior's (mean, log_var), each [M, z]."""

    def __init__(self, z_size: int, *, gen: torch.Generator,
                 inter_num_ch: int = 128):
        super().__init__()
        self.z_size = z_size
        self.linear = nn.Sequential(TorchLinear(1, inter_num_ch, gen),
                                    nn.LeakyReLU(_SLOPE),
                                    TorchLinear(inter_num_ch, 2 * z_size, gen))

    def forward(self, labels):
        h = F.leaky_relu(self.linear[0](labels), _SLOPE)
        h = self.linear[2](h)
        return h[..., :self.z_size], h[..., self.z_size:]
