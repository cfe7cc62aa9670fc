"""SPADE input decoders: z + anatomy-code modulation -> reconstructed image.

Reference: ``SPADEBlockNew`` (src/model.py:2424-2454) and the split pair
``SPADENewShared`` (zi scaler + blocks 1-3, src/model.py:2540-2582) +
``SPADENewNotShared`` (blocks 4-6 + 1x1 head, one per modality,
src/model.py:2584-2632), selected by ``shared_inp_dec: False``.

Every resize in SPADE uses align_corners=False.  The instance-norm +
modulation interior of each block runs through ``ops.kernels.in_modulate``
when ``use_pallas`` is set (the CUDA kernel on the card), else through the
plain composition.  Activations are [N, C, H, W] with N = M*B.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from representation_disentanglement_torch.models.layers import (
    MaybeCondConv, TorchLinear)
from representation_disentanglement_torch.ops import (
    apply_act, bilinear_resize)
from representation_disentanglement_torch.ops.kernels import (
    in_modulate, in_modulate_plain)


class SPADEBlock(nn.Module):
    """si-stream conv -> (gamma, beta); zi-stream instance-norm modulated by
    them; then the ``out`` conv."""

    def __init__(self, input_size, in_num_ch: int, out_num_ch: int,
                 s_num_ch: int, *, gen: torch.Generator,
                 is_cond: bool = False, use_pallas: bool = False):
        super().__init__()
        self.input_size = tuple(input_size)
        self.use_pallas = use_pallas
        cv = lambda ci, co: MaybeCondConv(ci, co, 3, 1, 1, gen=gen,
                                          is_cond=is_cond)
        self.si_layers = cv(s_num_ch, in_num_ch)
        self.gamma = cv(in_num_ch, in_num_ch)
        self.beta = cv(in_num_ch, in_num_ch)
        self.out = cv(in_num_ch, out_num_ch)

    def forward(self, si, zi, types=None):
        si_up = bilinear_resize(si, self.input_size, align_corners=False)
        si_out = self.si_layers(si_up, types)
        gamma = self.gamma(si_out, types)
        beta = self.beta(si_out, types)
        interior = in_modulate if self.use_pallas else in_modulate_plain
        return self.out(interior(zi, gamma, beta), types)


def _up2(x):
    return bilinear_resize(x, (2 * x.shape[-2], 2 * x.shape[-1]),
                           align_corners=False)


class SPADEShared(nn.Module):
    """zi_scaler + blocks 1-3; output at 1/4 resolution (the reference
    reuses its x2 upsample after sp3, src/model.py:2571-2573)."""

    def __init__(self, image_size, *, gen: torch.Generator, z_size: int = 16,
                 z_num_ch: int = 128, s_num_ch: int = 4,
                 is_cond: bool = False, use_pallas: bool = False):
        super().__init__()
        hs, ws = image_size
        self.z_num_ch = z_num_ch
        self.h32, self.w32 = hs // 32, ws // 32
        self.zi_scaler = TorchLinear(z_size, self.h32 * self.w32 * z_num_ch,
                                     gen)
        kw = dict(gen=gen, is_cond=is_cond, use_pallas=use_pallas)
        zc = z_num_ch
        self.sp1 = SPADEBlock((hs // 32, ws // 32), zc, zc, s_num_ch, **kw)
        self.sp2 = SPADEBlock((hs // 16, ws // 16), zc, zc, s_num_ch, **kw)
        self.sp3 = SPADEBlock((hs // 8, ws // 8), zc, zc, s_num_ch, **kw)

    def forward(self, si, zi, types=None):
        """si: [N, Cs, H, W]; zi: [N, z] -> [N, z_num_ch, H/4, W/4]."""
        # channel-major reshape as in torch (src/model.py:2525-2526)
        z0 = self.zi_scaler(zi).view(-1, self.z_num_ch, self.h32, self.w32)
        h = self.sp1(si, z0, types)
        h = self.sp2(si, _up2(h), types)
        h = self.sp3(si, _up2(h), types)
        return _up2(h)


class SPADENotShared(nn.Module):
    """Blocks 4-6 + the 1x1 ``out`` head; one copy per modality."""

    def __init__(self, image_size, *, gen: torch.Generator,
                 in_num_ch: int = 7, z_num_ch: int = 128, s_num_ch: int = 4,
                 is_cond: bool = False, output_activation: str = "softplus",
                 use_pallas: bool = False):
        super().__init__()
        hs, ws = image_size
        zc = z_num_ch
        kw = dict(gen=gen, is_cond=is_cond, use_pallas=use_pallas)
        self.sp4 = SPADEBlock((hs // 4, ws // 4), zc, zc // 2, s_num_ch, **kw)
        self.sp5 = SPADEBlock((hs // 2, ws // 2), zc // 2, zc // 4, s_num_ch,
                              **kw)
        self.sp6 = SPADEBlock((hs, ws), zc // 4, zc // 8, s_num_ch, **kw)
        self.out = MaybeCondConv(zc // 8, in_num_ch, 1, 1, 0, gen=gen,
                                 is_cond=is_cond)
        self.output_activation = output_activation

    def forward(self, si, mid, types=None):
        h = self.sp4(si, mid, types)
        h = self.sp5(si, _up2(h), types)
        h = self.sp6(si, _up2(h), types)
        return apply_act(self.out(h, types), self.output_activation)
