"""The multi-modal disentanglement model (reference ``MultimodalModel``,
src/model.py:2916-3258): the serving path.

Public methods keep the JAX package's layout: inputs [M, B, H, W, Cb],
mask [B, M], mask_img [B, H, W]; outputs x_hat [M, B, H, W, Cb] and
y [B, H, W, out].  Inside, activations are NCHW with the modality axis
folded into the batch, [M*B, C, H, W], group-major.

Ported configuration: shared anatomy and modality encoders, the split SPADE
input decoder (``shared_inp_dec: False``) with one not-shared half per
modality (``notshared_impl: 'loop'``), and the 'U+SA' output decoder, in
eval mode.  ``synthesize`` is the missing-modality serving call: the M
decodes from one anatomy source plus the fused y decode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.anatomy import (
    AnatomyEncoderDec, AnatomyEncoderEnc, anatomy_activation)
from representation_disentanglement_torch.models.generators import (
    make_output_decoder)
from representation_disentanglement_torch.models.modality import (
    ModalityEncoder)
from representation_disentanglement_torch.models.spade import (
    SPADEBlock, SPADENotShared, SPADEShared)


def fuse_anatomy(s: torch.Tensor, mask: torch.Tensor, fuse_method: str):
    """Per-sample mask-aware fusion of anatomy codes.

    s: [M, B, Cs, H, W]; mask: [B, M] -> [B, Cs or 3*Cs, H, W]."""
    m = mask.t()[:, :, None, None, None].to(s.dtype)       # [M, B, 1, 1, 1]
    cnt = torch.clamp_min(m.sum(0), 1e-8)
    mean = (s * m).sum(0) / cnt
    if fuse_method == "mean":
        return mean
    smax = torch.where(m > 0, s, torch.finfo(s.dtype).min).amax(0)
    if fuse_method == "max":
        return smax
    if fuse_method == "mean-max-min":
        smin = torch.where(m > 0, s, torch.finfo(s.dtype).max).amin(0)
        return torch.cat([mean, smax, smin], dim=1)
    raise ValueError(f"unknown fuse_method {fuse_method!r}")


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[M, B, H, W, C] -> [M*B, C, H, W]."""
    m, b, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(m * b, c, h, w)


def from_nchw(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[M*B, C, H, W] -> [M, B, H, W, C]."""
    n, c, h, w = x.shape
    return x.view(groups, n // groups, c, h, w).permute(0, 1, 3, 4, 2)


class MultimodalModel(nn.Module):
    def __init__(self, *, gen: torch.Generator, modality_num: int = 4,
                 in_num_ch: int = 7, out_num_ch: int = 1, s_num_ch: int = 4,
                 z_size: int = 16, input_size=(160, 192),
                 first_num_ch: int = 32, is_cond: bool = True,
                 fuse_method: str = "mean", input_output_act: str = "no",
                 target_output_act: str = "no",
                 target_model_name: str = "U+SA",
                 ana_dec_act: str = "softmax",
                 softmax_remove_mask: bool = True, fix_act_bug: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        M = modality_num
        self.modality_num = M
        self.fuse_method = fuse_method
        self.ana_dec_act = ana_dec_act
        self.softmax_remove_mask = softmax_remove_mask
        self.anatomy_encoder_enc_list = nn.ModuleList([AnatomyEncoderEnc(
            in_num_ch, gen=gen, first_num_ch=first_num_ch, is_cond=is_cond,
            fix_act_bug=fix_act_bug)])
        self.anatomy_encoder_dec = AnatomyEncoderDec(
            gen=gen, first_num_ch=first_num_ch, out_num_ch=s_num_ch,
            is_cond=is_cond, fix_act_bug=fix_act_bug)
        self.modality_encoder_list = nn.ModuleList([ModalityEncoder(
            in_num_ch, input_size, gen=gen, first_num_ch=16, z_size=z_size,
            is_cond=is_cond)])
        dec_kw = dict(gen=gen, z_num_ch=128, s_num_ch=s_num_ch,
                      is_cond=is_cond, use_pallas=use_pallas)
        # entries 0..M-1: per-modality halves; entry M: the shared half
        self.input_decoder_list = nn.ModuleList(
            [SPADENotShared(input_size, in_num_ch=in_num_ch,
                            output_activation=input_output_act, **dec_kw)
             for _ in range(M)]
            + [SPADEShared(input_size, z_size=z_size, **dec_kw)])
        fuse_ch = 3 * s_num_ch if fuse_method == "mean-max-min" else s_num_ch
        self.output_decoder = make_output_decoder(
            target_model_name, fuse_ch, out_num_ch, target_output_act,
            gen=gen, fix_act_bug=fix_act_bug)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def set_use_pallas(self, on: bool) -> None:
        """Route every SPADE interior through the kernel (True) or the
        plain composition (False)."""
        for m in self.modules():
            if isinstance(m, SPADEBlock):
                m.use_pallas = bool(on)

    def _types(self) -> torch.Tensor:
        # inputs_type = (1+i) (src/model.py:3138)
        return torch.arange(1, self.modality_num + 1, dtype=torch.float32,
                            device=self.device)

    # ---- NCHW internals -------------------------------------------------
    def _encode_anatomy(self, xf, mask_img):
        types = self._types()
        feats = self.anatomy_encoder_enc_list[0](xf, types)
        s_logits = self.anatomy_encoder_dec(feats, types)
        return anatomy_activation(s_logits, mask_img, self.ana_dec_act,
                                  self.softmax_remove_mask)

    def _encode_modality(self, xf):
        return self.modality_encoder_list[0](xf, self._types())

    def _decode_y(self, sf, mask):
        s = sf.view(self.modality_num, -1, *sf.shape[1:])
        y, _ = self.output_decoder(fuse_anatomy(s, mask, self.fuse_method))
        return y

    # ---- public API, JAX layout ----------------------------------------
    def encode_anatomy(self, x, mask_img):
        """x: [M, B, H, W, Cb]; mask_img: [B, H, W] -> s [M, B, H, W, Cs]."""
        return from_nchw(self._encode_anatomy(to_nchw(x), mask_img),
                         self.modality_num)

    def encode_modality(self, x, s=None):
        """-> (z_mean, z_log_var): [M, B, z].  ``s`` is unused (the
        shipped ``mod_enc_s: False``)."""
        M, B = x.shape[:2]
        z_mean, z_log_var = self._encode_modality(to_nchw(x))
        return z_mean.view(M, B, -1), z_log_var.view(M, B, -1)

    def decode_outputs(self, s, mask):
        """The fused y decode. s: [M, B, H, W, Cs], mask: [B, M] ->
        y_fused [B, H, W, out].  (The per-modality y decodes of the JAX
        ``decode_outputs`` come with the training slice.)"""
        return self._decode_y(to_nchw(s), mask).permute(0, 2, 3, 1)

    def synthesize(self, x, mask, mask_img, *, source: int = 0,
                   z: Optional[torch.Tensor] = None,
                   s: Optional[torch.Tensor] = None, with_y: bool = True):
        """Missing-modality serving: decode every modality from the anatomy
        of ``source`` (and its per-modality decoder half).

        x: [M, B, H, W, Cb] with absent modalities zero-filled; mask [B, M];
        ``z``: optional [M, B, z] override (default: the encoder means);
        ``s``: optional precomputed anatomy codes [M, B, H, W, Cs];
        ``with_y=False`` skips the fused y decode.
        Returns (x_hat [M, B, H, W, Cb], y_fused [B, H, W, out] or None)."""
        M, B = x.shape[:2]
        xf = to_nchw(x)
        sf = self._encode_anatomy(xf, mask_img) if s is None else to_nchw(s)
        if z is None:
            zf, _ = self._encode_modality(xf)
        else:
            zf = z.reshape(M * B, -1)
        zf = zf.to(sf.dtype)
        types = self._types()
        s_src = sf[source * B:(source + 1) * B].repeat(M, 1, 1, 1)
        mid = self.input_decoder_list[M](s_src, zf, types)
        x_hat = from_nchw(self.input_decoder_list[source](s_src, mid, types),
                          M)
        if not with_y:
            return x_hat, None
        return x_hat, self._decode_y(sf, mask).permute(0, 2, 3, 1)


def build_model(cfg: Config, device=None,
                generator: Optional[torch.Generator] = None
                ) -> MultimodalModel:
    """The model of ``cfg`` in eval mode, initialized from ``generator``
    (default: seeded with ``cfg.seed``) on ``device`` (default: CUDA)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the port on the CPU")
        device = "cuda"
    old = cfg.others.get("old", False)
    unported = []
    if cfg.shared_inp_dec or old:
        unported.append("shared_inp_dec / others.old (SPADEFull)")
    if not (cfg.shared_ana_enc and cfg.shared_mod_enc):
        unported.append("per-modality encoders")
    if cfg.notshared_impl != "loop":
        unported.append(f"notshared_impl={cfg.notshared_impl!r}")
    if cfg.others.get("mod_enc_s", True):
        unported.append("others.mod_enc_s")
    if unported:
        raise NotImplementedError(
            "not ported yet (ROADMAP.md, queue 1): " + ", ".join(unported))
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    model = MultimodalModel(
        gen=gen, modality_num=cfg.modality_num, in_num_ch=cfg.block_ch,
        out_num_ch=cfg.out_num_ch, s_num_ch=cfg.s_num_ch, z_size=cfg.z_size,
        input_size=cfg.input_size, is_cond=cfg.is_cond,
        fuse_method=cfg.fuse_method, input_output_act=cfg.input_output_act,
        target_output_act=cfg.target_output_act,
        target_model_name=cfg.target_model_name,
        ana_dec_act=cfg.others.get("ana_dec_act", "softmax"),
        softmax_remove_mask=cfg.others.get("softmax_remove_mask", False),
        fix_act_bug=cfg.fix_activation_bug, use_pallas=cfg.use_pallas)
    return model.to(device).eval()
