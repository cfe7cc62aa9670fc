"""Modality (appearance) encoder -> Gaussian z.

Reference: ``ModalityEncoderNew`` (src/model.py:2332-2400): 5 stride-2 3x3
(cond)convs with real LeakyReLU(0.2), a CHW-major flatten of the
(128, H/32, W/32) map, one FC + LeakyReLU, then the mean / log_var heads.
The flatten is torch's CHW order, as in the reference; the JAX package
flattens HWC-major with a permuted ``fcs`` weight (weights.py undoes it).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.layers import (
    MaybeCondConv, TorchLinear)


class ModalityEncoder(nn.Module):
    def __init__(self, in_ch: int, input_size, *, gen: torch.Generator,
                 first_num_ch: int = 16, z_size: int = 16,
                 is_cond: bool = False):
        super().__init__()
        f = first_num_ch
        chs = [in_ch, f, 2 * f, 4 * f, 8 * f, 8 * f]
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    MaybeCondConv(chs[i], chs[i + 1], 3, 2, 1, gen=gen,
                                  is_cond=is_cond))
        flat = 8 * f * (input_size[0] // 32) * (input_size[1] // 32)
        self.fcs = nn.ModuleList([TorchLinear(flat, 2 * z_size, gen)])
        self.mean = TorchLinear(2 * z_size, z_size, gen)
        self.log_var = TorchLinear(2 * z_size, z_size, gen)

    def forward(self, x, types=None):
        """x: [M*B, Cb, H, W] -> (z_mean, z_log_var): [M*B, z]."""
        h = x
        for i in range(5):
            h = F.leaky_relu(getattr(self, f"conv{i + 1}")(h, types), 0.2)
        h = F.leaky_relu(self.fcs[0](h.flatten(1)), 0.2)
        return self.mean(h), self.log_var(h)
