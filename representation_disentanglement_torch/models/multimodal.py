"""The multi-modal disentanglement model (reference ``MultimodalModel``,
src/model.py:2916-3258): the training forward and the serving path.

Public methods keep the JAX package's layout: inputs [M, B, H, W, Cb],
mask [B, M], mask_img [B, H, W]; outputs x_hat [M, B, H, W, Cb],
y [B, H, W, out], the decode grid [M_i, M_j, B, H, W, Cb].  Inside,
activations are NCHW with the modality axis folded into the batch,
[M*B, C, H, W], group-major.

Every 2D option of the JAX ``MultimodalModel`` (JAX models/multimodal.py:
65-100): shared anatomy and modality encoders, or one per modality
(``shared_ana_enc`` / ``shared_mod_enc: False``; module m runs on modality
m's B samples, so each of its BatchNorms normalizes one modality, what the
JAX package's vmapped encoders are written to compute, though they do not
run there, ROADMAP.md §3; the anatomy decoder half is always shared); the modality encoder reading the anatomy codes too
(``mod_enc_s``); the split SPADE input decoder (``shared_inp_dec: False``)
with one not-shared half per modality, or the single ``SPADEFull``
(``shared_inp_dec: True``); the output decoders 'U', 'U+SA', 'U+SA+CA' and
'U+SSA+CA'; the optional anatomy-code discriminator (``is_discrim_s``, from
``lambda_adv_s > 0``), learned z prior (``is_distri_z``) and the trained
RGB projection of the VGG similarity paths (``vgg_pre``).  The JAX
package's ``notshared_impl`` ('loop' or 'vmap') only lays out its own
parameters; the port's halves are the same modules either way
(``weights.from_jax_params`` reads both layouts).
``forward`` (``model(...)``) is the training forward in the reference's
stage order; ``synthesize`` is the missing-modality serving call: the M
decodes from one anatomy source plus the fused y decode.  The port has no
rematerialization: the flagship runs with ``remat: False``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.anatomy import (
    AnatomyEncoderDec, AnatomyEncoderEnc, anatomy_activation)
from representation_disentanglement_torch.models.discriminator import (
    Discriminator, ModalityDistribution)
from representation_disentanglement_torch.models.generators import (
    make_output_decoder)
from representation_disentanglement_torch.models.layers import (
    MaybeCondConv, resolve_device, set_cond_mode, set_fuse_bn)
from representation_disentanglement_torch.models.modality import (
    ModalityEncoder)
from representation_disentanglement_torch.models.spade import (
    SPADEBlock, SPADEFull, SPADENotShared, SPADEShared)
from representation_disentanglement_torch.parallel.mesh import (
    global_shape, local_part)


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
                 use_pallas: bool = False, is_discrim_s: bool = False,
                 is_distri_z: bool = False, shared_ana_enc: bool = True,
                 shared_mod_enc: bool = True, shared_inp_dec: bool = False,
                 mod_enc_s: bool = False, vgg_pre: bool = False):
        super().__init__()
        M = modality_num
        self.modality_num = M
        self.is_discrim_s, self.is_distri_z = is_discrim_s, is_distri_z
        self.shared_ana_enc = shared_ana_enc
        self.shared_mod_enc = shared_mod_enc
        self.shared_inp_dec, self.mod_enc_s = shared_inp_dec, mod_enc_s
        self.fuse_method = fuse_method
        self.ana_dec_act = ana_dec_act
        self.softmax_remove_mask = softmax_remove_mask
        self.anatomy_encoder_enc_list = nn.ModuleList([AnatomyEncoderEnc(
            in_num_ch, gen=gen, first_num_ch=first_num_ch, is_cond=is_cond,
            fix_act_bug=fix_act_bug)
            for _ in range(1 if shared_ana_enc else M)])
        self.anatomy_encoder_dec = AnatomyEncoderDec(
            gen=gen, first_num_ch=first_num_ch, out_num_ch=s_num_ch,
            is_cond=is_cond, fix_act_bug=fix_act_bug)
        self.modality_encoder_list = nn.ModuleList([ModalityEncoder(
            in_num_ch, input_size, gen=gen, first_num_ch=16, z_size=z_size,
            is_cond=is_cond, use_s=mod_enc_s, s_num_ch=s_num_ch)
            for _ in range(1 if shared_mod_enc else M)])
        dec_kw = dict(gen=gen, z_num_ch=128, s_num_ch=s_num_ch,
                      is_cond=is_cond, use_pallas=use_pallas)
        if shared_inp_dec:
            self.input_decoder_list = nn.ModuleList([SPADEFull(
                input_size, in_num_ch=in_num_ch, z_size=z_size,
                output_activation=input_output_act, **dec_kw)])
        else:
            # entries 0..M-1: per-modality halves; entry M: the shared half
            self.input_decoder_list = nn.ModuleList(
                [SPADENotShared(input_size, in_num_ch=in_num_ch,
                                output_activation=input_output_act,
                                **dec_kw)
                 for _ in range(M)]
                + [SPADEShared(input_size, z_size=z_size, **dec_kw)])
        fuse_ch = 3 * s_num_ch if fuse_method == "mean-max-min" else s_num_ch
        self.output_decoder = make_output_decoder(
            target_model_name, fuse_ch, out_num_ch, target_output_act,
            gen=gen, fix_act_bug=fix_act_bug)
        if is_discrim_s:
            self.discrim_s = Discriminator(s_num_ch, input_size, gen=gen)
        if is_distri_z:
            self.distri_z = ModalityDistribution(z_size, gen=gen)
        if vgg_pre:
            # the trained s -> RGB projection of the VGG paths
            # (src/model.py:2945-2946); the VGG16 weights are the losses'
            # constants (training.train.load_vgg_constants)
            self.vgg_pre = MaybeCondConv(s_num_ch, 3, 3, 1, 1, gen=gen)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def set_use_pallas(self, on: bool) -> None:
        """Route every SPADE interior through the kernel (True) or the
        plain composition (False)."""
        for m in self.modules():
            if isinstance(m, SPADEBlock):
                m.use_pallas = bool(on)

    def set_fuse_bn(self, on: bool) -> None:
        """Route every train-mode BatchNorm through the fused kernels (True)
        or the plain statistics and ``batch_norm_apply`` (False)."""
        set_fuse_bn(self, on)

    def _types(self) -> torch.Tensor:
        # inputs_type = (1+i) (src/model.py:3138)
        return torch.arange(1, self.modality_num + 1, dtype=torch.float32,
                            device=self.device)

    # ---- NCHW internals -------------------------------------------------
    def _per_modality(self, mods, types, *tensors):
        """Module m of ``mods`` on modality m's rows of each [M*B, ...]
        tensor (None passes through) with types[m:m+1]; the outputs, a
        tuple of tensors, concatenated back group-major."""
        M = self.modality_num
        B = tensors[0].shape[0] // M
        outs = [mods[m](*(None if t is None else t[m * B:(m + 1) * B]
                          for t in tensors), types[m:m + 1])
                for m in range(M)]
        return tuple(torch.cat(o, 0) for o in zip(*outs))

    def _encode_anatomy(self, xf, mask_img):
        types = self._types()
        if self.shared_ana_enc:
            feats = self.anatomy_encoder_enc_list[0](xf, types)
        else:
            feats = self._per_modality(self.anatomy_encoder_enc_list, types,
                                       xf)
        s_logits = self.anatomy_encoder_dec(feats, types)
        return anatomy_activation(s_logits, mask_img, self.ana_dec_act,
                                  self.softmax_remove_mask)

    def _encode_modality(self, xf, sf=None):
        """-> (z_mean, z_log_var) [M*B, z]; ``sf``, the anatomy codes, is
        read with ``mod_enc_s``."""
        if self.mod_enc_s and sf is None:
            raise ValueError("mod_enc_s: the modality encoder needs the "
                             "anatomy codes s")
        types = self._types()
        if self.shared_mod_enc:
            return self.modality_encoder_list[0](xf, sf, types)
        return self._per_modality(self.modality_encoder_list, types, xf, sf)

    def _decode_y(self, sf, mask, per_modality: bool = False):
        """-> (y_list [M*B, out, H, W] or None, y_fused [B, out, H, W]).
        With ``per_modality`` the M per-modality decodes and the fused one
        run as one call of M+1 groups, in the reference's BatchNorm call
        order (main_missing.py:184-185)."""
        M = self.modality_num
        s = sf.view(M, -1, *sf.shape[1:])
        fused = fuse_anatomy(s, mask, self.fuse_method)
        if not per_modality:
            y, _ = self.output_decoder(fused)
            return None, y
        ones = torch.ones(s.shape[1], 1, dtype=s.dtype, device=s.device)
        stacked = torch.cat([fuse_anatomy(s[i:i + 1], ones, self.fuse_method)
                             for i in range(M)] + [fused], dim=0)
        y, _ = self.output_decoder(stacked, groups=M + 1)
        n = M * s.shape[1]
        return y[:n], y[n:]

    def _decode_grid(self, sf, zf):
        """Every (anatomy i, modality j) decode.  sf: [M*B, Cs, H, W],
        zf: [M*B, z] -> [M_i, M_j*B, Cb, H, W].  The shared half (or the
        whole ``SPADEFull``) runs on the flattened [M*M*B] grid with types
        t[i, j] = 1+j; the not-shared half of anatomy source i on s[i] and
        mid[i] with types [M]."""
        M = self.modality_num
        B = sf.shape[0] // M
        zf = zf.to(sf.dtype)             # the z-stream in s's dtype (:237)
        types = self._types()
        s_pair = sf.view(M, 1, B, *sf.shape[1:]).expand(
            M, M, B, *sf.shape[1:]).reshape(M, M * B, *sf.shape[1:])
        z_pair = zf.view(1, M * B, -1).expand(M, M * B, zf.shape[-1])
        if self.shared_inp_dec:
            out = self.input_decoder_list[0](
                s_pair.reshape(M * M * B, *sf.shape[1:]),
                z_pair.reshape(M * M * B, -1), types.repeat(M))
            return out.view(M, M * B, *out.shape[1:])
        mid = self.input_decoder_list[M](
            s_pair.reshape(M * M * B, *sf.shape[1:]),
            z_pair.reshape(M * M * B, -1), types.repeat(M))
        mid = mid.view(M, M * B, *mid.shape[1:])
        return torch.stack([self.input_decoder_list[i](s_pair[i], mid[i],
                                                       types)
                            for i in range(M)], dim=0)

    # ---- public API, JAX layout ----------------------------------------
    def encode_anatomy(self, x, mask_img):
        """x: [M, B, H, W, Cb]; mask_img: [B, H, W] -> s [M, B, H, W, Cs]."""
        return from_nchw(self._encode_anatomy(to_nchw(x), mask_img),
                         self.modality_num)

    def encode_modality(self, x, s=None):
        """-> (z_mean, z_log_var): [M, B, z].  ``s`` [M, B, H, W, Cs], the
        anatomy codes, is read with ``mod_enc_s``."""
        M, B = x.shape[:2]
        z_mean, z_log_var = self._encode_modality(
            to_nchw(x), None if s is None else to_nchw(s))
        return z_mean.view(M, B, -1), z_log_var.view(M, B, -1)

    def sample_z(self, generator: torch.Generator, z_mean, z_log_var):
        """z = mean + eps * exp(0.5 * log_var) (src/model.py:3159-3162), eps
        an f32 standard normal drawn from ``generator``; inside a
        ``data_parallel`` scope drawn at the global batch's shape [M, B, z]
        and cut to the rank's rows, the unsharded step's noise."""
        eps = torch.randn(global_shape(z_mean.shape, 1), generator=generator,
                          device=z_mean.device, dtype=torch.float32)
        return z_mean + local_part(eps, 1) * torch.exp(0.5 * z_log_var)

    def decode_inputs_grid(self, s, z):
        """s: [M, B, H, W, Cs], z: [M, B, z] -> grid [M_i, M_j, B, H, W, Cb]:
        grid[i, j] decodes modality j from the anatomy of i; the diagonal
        holds the self-reconstructions."""
        M, B = s.shape[:2]
        return self._grid_layout(self._decode_grid(
            to_nchw(s), z.reshape(M * B, -1)))

    def _grid_layout(self, g):
        M = self.modality_num
        return g.view(M, M, -1, *g.shape[2:]).permute(0, 1, 2, 4, 5, 3)

    def decode_outputs(self, s, mask, *, per_modality: bool = True):
        """y decodes. s: [M, B, H, W, Cs], mask: [B, M] ->
        (y_list [M, B, H, W, out] or None, y_fused [B, H, W, out])."""
        y_list, y_fused = self._decode_y(to_nchw(s), mask, per_modality)
        if y_list is not None:
            y_list = from_nchw(y_list, self.modality_num)
        return y_list, y_fused.permute(0, 2, 3, 1)

    def discriminate(self, s_pair):
        """s_pair: [2, B, H, W, Cs] -> logits [2, B]; the two groups are
        normalized apart in train mode."""
        return self.discrim_s(to_nchw(s_pair), groups=2).view(2, -1)

    def z_prior(self):
        """The learned per-modality z prior (src/model.py:3362-3370) ->
        (mean, log_var): [M, z]."""
        return self.distri_z(self._types()[:, None])

    def forward(self, x, mask, mask_img,
                generator: Optional[torch.Generator] = None, *,
                compute_y: bool = True, latent_cycle: bool = True,
                adv_pair=None) -> dict:
        """The training forward in the reference's stage order
        (main_missing.py:175-190, 228-231): anatomy encode, modality
        encode, z sampled from ``generator`` in train mode (else the mean),
        the M x M decode grid, the y decodes when ``compute_y``, and the
        latent cycle, which re-encodes the grid diagonal (a second set of M
        running-stat updates on the anatomy encoder's BatchNorms; with
        ``mod_enc_s`` its anatomy codes feed the modality encoder).

        Given an ``adv_pair`` (i, j), which needs the discriminator, the
        discriminator's logits of s[i] and s[j]; with the z prior, the
        prior.

        Returns the JAX keys: s, z, z_mean, z_log_var [M, B, ...],
        x_fake_grid, y_fake_list, y_fake_fused (with ``compute_y``),
        z_mean_new (with ``latent_cycle``), d_logits [2, B] (with
        ``adv_pair``), z_prior (with the prior)."""
        M, B = x.shape[:2]
        xf = to_nchw(x)
        sf = self._encode_anatomy(xf, mask_img)
        z_mean, z_log_var = (t.view(M, B, -1)
                             for t in self._encode_modality(xf, sf))
        if self.training and generator is not None:
            z = self.sample_z(generator, z_mean, z_log_var)
        else:
            z = z_mean
        grid = self._decode_grid(sf, z.reshape(M * B, -1))
        out = dict(s=from_nchw(sf, M), z=z, z_mean=z_mean,
                   z_log_var=z_log_var, x_fake_grid=self._grid_layout(grid))
        if compute_y:
            y_list, y_fused = self._decode_y(sf, mask, per_modality=True)
            out.update(y_fake_list=from_nchw(y_list, M),
                       y_fake_fused=y_fused.permute(0, 2, 3, 1))
        if latent_cycle:
            diag = torch.cat([grid[i, i * B:(i + 1) * B] for i in range(M)])
            if self.mod_enc_s:
                s_new = self._encode_anatomy(diag, mask_img)
            else:
                # the re-encoded anatomy reaches no loss; in train mode it
                # runs for its BatchNorm running-stat updates, as in the
                # reference, without keeping a graph.  In eval mode it
                # would change nothing (JAX's compiler drops it there too).
                s_new = None
                if self.training:
                    with torch.no_grad():
                        self._encode_anatomy(diag, mask_img)
            out["z_mean_new"] = self._encode_modality(diag, s_new)[0].view(
                M, B, -1)
        if adv_pair is not None:
            out["d_logits"] = self.discriminate(
                out["s"][[int(a) for a in adv_pair]])
        if self.is_distri_z:
            out["z_prior"] = self.z_prior()
        return out

    def synthesize(self, x, mask, mask_img, *, source: int = 0,
                   z: Optional[torch.Tensor] = None,
                   s: Optional[torch.Tensor] = None, with_y: bool = True):
        """Missing-modality serving: decode every modality from the anatomy
        of ``source`` (and its per-modality decoder half).  Under the JAX
        package's 'vmap' halves JAX decodes the whole grid and takes row
        ``source``; the port's halves are separate modules, so it decodes
        only that row, the same values.

        x: [M, B, H, W, Cb] with absent modalities zero-filled; mask [B, M];
        ``z``: optional [M, B, z] override (default: the encoder means);
        ``s``: optional precomputed anatomy codes [M, B, H, W, Cs];
        ``with_y=False`` skips the fused y decode.
        Returns (x_hat [M, B, H, W, Cb], y_fused [B, H, W, out] or None)."""
        M, B = x.shape[:2]
        xf = to_nchw(x)
        sf = self._encode_anatomy(xf, mask_img) if s is None else to_nchw(s)
        if z is None:
            zf, _ = self._encode_modality(xf, sf)
        else:
            zf = z.reshape(M * B, -1)
        zf = zf.to(sf.dtype)
        types = self._types()
        s_src = sf[source * B:(source + 1) * B].repeat(M, 1, 1, 1)
        if self.shared_inp_dec:
            x_hat = self.input_decoder_list[0](s_src, zf, types)
        else:
            mid = self.input_decoder_list[M](s_src, zf, types)
            x_hat = self.input_decoder_list[source](s_src, mid, types)
        x_hat = from_nchw(x_hat, M)
        if not with_y:
            return x_hat, None
        return x_hat, self._decode_y(sf, mask)[1].permute(0, 2, 3, 1)


def build_model(cfg: Config, device=None,
                generator: Optional[torch.Generator] = None
                ) -> MultimodalModel:
    """The model of ``cfg`` in eval mode, initialized from ``generator``
    (default: seeded with ``cfg.seed``) on ``device`` (default: CUDA).
    ``others.old`` selects the reference's pre-CondConv module set, the
    non-conditional configuration with ``SPADEFull`` (JAX main_missing.py:
    53-58); ``others.mod_enc_s`` defaults to True when absent, as there.
    ``cfg.cond_mode`` is set on every CondConv and ``cfg.fuse_bn`` on every
    BatchNorm (JAX main_missing.py:60-62).
    ``model.train()`` switches to the training forward."""
    device = resolve_device(device)
    old = cfg.others.get("old", False)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    model = MultimodalModel(
        gen=gen, modality_num=cfg.modality_num, in_num_ch=cfg.block_ch,
        out_num_ch=cfg.out_num_ch, s_num_ch=cfg.s_num_ch, z_size=cfg.z_size,
        input_size=cfg.input_size, is_cond=cfg.is_cond and not old,
        fuse_method=cfg.fuse_method, input_output_act=cfg.input_output_act,
        target_output_act=cfg.target_output_act,
        target_model_name=cfg.target_model_name,
        ana_dec_act=cfg.others.get("ana_dec_act", "softmax"),
        softmax_remove_mask=cfg.others.get("softmax_remove_mask", False),
        fix_act_bug=cfg.fix_activation_bug, use_pallas=cfg.use_pallas,
        is_discrim_s=cfg.is_discrim_s, is_distri_z=cfg.is_distri_z,
        shared_ana_enc=cfg.shared_ana_enc, shared_mod_enc=cfg.shared_mod_enc,
        shared_inp_dec=cfg.shared_inp_dec or old,
        mod_enc_s=cfg.others.get("mod_enc_s", True),
        vgg_pre=cfg.s_compact_method == "vgg"
        or cfg.s_sim_method == "perceptual")
    model.set_fuse_bn(cfg.fuse_bn)
    set_cond_mode(model, cfg.cond_mode)
    return model.to(device).eval()
