"""Plain float32 reference of the multi-modal disentanglement model.

Written from the published model (ouyangjiahong/representation-
disentanglement, src/model.py; arXiv:2102.11456) as the benchmark's
configurations use it, in plain PyTorch: no kernel, no fused op, no
resize matrices, nothing of the measured package.  Parameter names are
the reference torch model's ``state_dict()`` names, so that one weight
dictionary made by the benchmark loads into both sides.

What it covers (and refuses otherwise): CondConv everywhere in the
encoders and the SPADE decoder (three experts routed by the modality
label 1+i), shared anatomy and modality encoders, the split SPADE input
decoder (one shared half, one not-shared half per modality), the 'U+SA'
output decoder, the softmax anatomy activation with the background
channel, mean fusion, and the reference's quirk Q1 (every block
activation but 'elu' is the identity; the real LeakyReLUs are the ones
written out).

Layouts: inputs [M, B, H, W, Cb], mask [B, M], mask_img [B, H, W];
inside, NCHW with the modality folded into the batch, group-major.

``quant`` (a ``Precision``) says how every convolution and linear layer
rounds: ``F32`` rounds nothing, the float32 reference; ``FP8`` is the
control, the same arithmetic in float8 as fp8 training runs it: the
products' operands in e4m3 and the gradient arriving at each product's
output in e5m2, each tensor scaled by its largest magnitude.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """Per-tensor scaled round trip through a float8 ``dtype``."""
    scale = largest / x.abs().amax().float().clamp_min(1e-30)
    return ((x * scale).to(dtype).to(x.dtype) / scale)


class _Operand(torch.autograd.Function):
    """e4m3 in the forward pass; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _OutputGrad(torch.autograd.Function):
    """The identity forward; the gradient rounded to e5m2 backward."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Precision:
    def __init__(self, operand=None, output=None):
        self.operand = operand or (lambda x: x)
        self.output = output or (lambda y: y)


F32 = Precision()
FP8 = Precision(_Operand.apply, _OutputGrad.apply)


class Lin(nn.Module):
    """Linear, weight [out, in]."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None
        self.fan_in, self.cond = n_in, False

    def forward(self, x, q=F32):
        return q.output(F.linear(q.operand(x), q.operand(self.weight),
                                 self.bias))


class Conv(nn.Module):
    """Conv2d, or with ``cond`` a CondConv2d of three experts whose kernel
    is mixed per group of the folded batch by sigmoid(fc(type))."""

    def __init__(self, ci: int, co: int, k: int, stride: int = 1,
                 pad: int = 0, cond: bool = False, bias: bool = True,
                 experts: int = 3):
        super().__init__()
        self.stride, self.pad, self.cond = stride, pad, cond
        self.fan_in = ci * k * k
        if cond:
            self.weight = nn.Parameter(torch.empty(experts, co, ci, k, k))
            self._routing_fn = nn.Module()
            self._routing_fn.fc = Lin(1, experts)
        else:
            self.weight = nn.Parameter(torch.empty(co, ci, k, k))
        self.bias = nn.Parameter(torch.empty(co)) if bias else None

    def forward(self, x, types=None, q=F32):
        if not self.cond:
            return q.output(F.conv2d(q.operand(x), q.operand(self.weight),
                                     self.bias, self.stride, self.pad))
        fc = self._routing_fn.fc
        route = torch.sigmoid(types.float()[:, None] @ fc.weight.t()
                              + fc.bias)                       # [G, E]
        outs = []
        for xg, r in zip(x.chunk(route.shape[0]), route):
            w = (r[:, None, None, None, None] * self.weight).sum(0)
            outs.append(q.output(F.conv2d(q.operand(xg), q.operand(w),
                                          self.bias, self.stride, self.pad)))
        return torch.cat(outs)


class BN(nn.Module):
    """BatchNorm2d, eps 1e-5: train mode normalizes each of ``groups``
    groups of the folded batch with its own biased batch statistics; eval
    mode uses the running statistics.  ``calibrating`` sets the running
    statistics to those of the batch it sees, first."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.calibrating = False

    def forward(self, x, groups: int = 1):
        w, b = self.weight[:, None, None], self.bias[:, None, None]
        if self.calibrating:
            self.running_mean.copy_(x.mean(dim=(0, 2, 3)))
            self.running_var.copy_(x.var(dim=(0, 2, 3)))
        if not self.training:
            return ((x - self.running_mean[:, None, None])
                    / torch.sqrt(self.running_var[:, None, None] + 1e-5)
                    * w + b)
        xg = x.reshape((groups, -1) + x.shape[1:])
        mean = xg.mean(dim=(1, 3, 4), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3, 4), keepdim=True)
        return ((xg - mean) / torch.sqrt(var + 1e-5) * w + b).reshape(x.shape)


def resize(x, hw, align_corners: bool):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=align_corners)


def up2(x):
    return resize(x, (2 * x.shape[-2], 2 * x.shape[-1]), False)


def act(x, name: str):
    if name == "no":
        return x
    if name == "softplus":
        return F.softplus(x)
    raise ValueError(f"output activation {name!r}")


class DownBlock(nn.Module):
    """Conv 4x4 stride 2 -> BN -> identity (quirk Q1).  ``old`` names the
    pair ``conv.0`` / ``conv.1`` as the output decoder's blocks do."""

    def __init__(self, ci, co, cond, old=False):
        super().__init__()
        self.old = old
        if old:
            self.conv = nn.ModuleList([Conv(ci, co, 4, 2, 1), BN(co)])
        else:
            self.conv = Conv(ci, co, 4, 2, 1, cond)
            self.bn = BN(co)

    def forward(self, x, types, groups, q):
        if self.old:
            return self.conv[1](self.conv[0](x, q=q), groups)
        return self.bn(self.conv(x, types, q), groups)


class UpBlock(nn.Module):
    """identity (Q1) -> bilinear x2 (align_corners=True) -> conv 3x3 ->
    BN -> concat(skip, up), or the conv alone when ``last``.  ``old``
    names the conv ``up.1``."""

    def __init__(self, ci, co, cond, last=False, old=False):
        super().__init__()
        self.old, self.last = old, last
        conv = Conv(ci, co, 3, 1, 1, cond)
        if old:
            self.up = nn.ModuleList([nn.Identity(), conv])
        else:
            self.conv = conv
        self.bn = None if last else BN(co)

    def forward(self, skip, x, types, groups, q):
        x = resize(x, (2 * x.shape[-2], 2 * x.shape[-1]), True)
        x = (self.up[1] if self.old else self.conv)(x, types, q)
        if self.last:
            return x
        return torch.cat([skip, self.bn(x, groups)], 1)


class AnatomyEnc(nn.Module):
    def __init__(self, ci, f=32):
        super().__init__()
        self.down_1 = Conv(ci, f, 4, 2, 1, True)
        self.down_2 = DownBlock(f, 2 * f, True)
        self.down_3 = DownBlock(2 * f, 4 * f, True)
        self.down_4 = DownBlock(4 * f, 8 * f, True)
        self.down_5 = DownBlock(8 * f, 8 * f, True)

    def forward(self, x, types, q):
        g = types.shape[0]
        d1 = F.leaky_relu(self.down_1(x, types, q), 0.2)
        d2 = self.down_2(d1, types, g, q)
        d3 = self.down_3(d2, types, g, q)
        d4 = self.down_4(d3, types, g, q)
        return d1, d2, d3, d4, self.down_5(d4, types, g, q)


class AnatomyDec(nn.Module):
    def __init__(self, out_ch, f=32):
        super().__init__()
        self.up_4 = UpBlock(8 * f, 8 * f, True)
        self.up_3 = UpBlock(16 * f, 4 * f, True)
        self.up_2 = UpBlock(8 * f, 2 * f, True)
        self.up_1 = UpBlock(4 * f, f, True)
        self.output = UpBlock(2 * f, out_ch, True, last=True)

    def forward(self, feats, types, q):
        d1, d2, d3, d4, d5 = feats
        g = types.shape[0]
        u = self.up_4(d4, d5, types, g, q)
        u = self.up_3(d3, u, types, g, q)
        u = self.up_2(d2, u, types, g, q)
        u = self.up_1(d1, u, types, g, q)
        return self.output(None, u, types, g, q)


class ModalityEnc(nn.Module):
    def __init__(self, ci, hw, z, f=16):
        super().__init__()
        chs = [ci, f, 2 * f, 4 * f, 8 * f, 8 * f]
        for i in range(5):
            setattr(self, f"conv{i + 1}", Conv(chs[i], chs[i + 1], 3, 2, 1,
                                               True))
        flat = 8 * f * (hw[0] // 32) * (hw[1] // 32)
        self.fcs = nn.ModuleList([Lin(flat, 2 * z)])
        self.mean = Lin(2 * z, z)
        self.log_var = Lin(2 * z, z)

    def forward(self, x, types, q):
        for i in range(5):
            x = F.leaky_relu(getattr(self, f"conv{i + 1}")(x, types, q), 0.2)
        h = F.leaky_relu(self.fcs[0](x.flatten(1), q), 0.2)
        return self.mean(h, q), self.log_var(h, q)


class SPADEBlock(nn.Module):
    """gamma, beta from the anatomy codes; the z-stream instance-normalized
    (per sample and channel, eps 1e-5) and modulated: zn (1 + gamma) +
    beta; then the ``out`` conv."""

    def __init__(self, size, ci, co, cs):
        super().__init__()
        self.size = size
        self.si_layers = Conv(cs, ci, 3, 1, 1, True)
        self.gamma = Conv(ci, ci, 3, 1, 1, True)
        self.beta = Conv(ci, ci, 3, 1, 1, True)
        self.out = Conv(ci, co, 3, 1, 1, True)

    def forward(self, si, zi, types, q):
        h = self.si_layers(resize(si, self.size, False), types, q)
        gamma, beta = self.gamma(h, types, q), self.beta(h, types, q)
        mean = zi.mean(dim=(2, 3), keepdim=True)
        var = (zi - mean).square().mean(dim=(2, 3), keepdim=True)
        zn = (zi - mean) / torch.sqrt(var + 1e-5)
        return self.out(zn * (1.0 + gamma) + beta, types, q)


class SPADEShared(nn.Module):
    def __init__(self, hw, z, cs, zc=128):
        super().__init__()
        h, w = hw
        self.zc, self.h32, self.w32 = zc, h // 32, w // 32
        self.zi_scaler = Lin(z, self.h32 * self.w32 * zc)
        self.sp1 = SPADEBlock((h // 32, w // 32), zc, zc, cs)
        self.sp2 = SPADEBlock((h // 16, w // 16), zc, zc, cs)
        self.sp3 = SPADEBlock((h // 8, w // 8), zc, zc, cs)

    def forward(self, si, zi, types, q):
        h = self.zi_scaler(zi, q).view(-1, self.zc, self.h32, self.w32)
        h = self.sp1(si, h, types, q)
        h = self.sp2(si, up2(h), types, q)
        return up2(self.sp3(si, up2(h), types, q))


class SPADENotShared(nn.Module):
    def __init__(self, hw, cb, cs, out_act, zc=128):
        super().__init__()
        h, w = hw
        self.sp4 = SPADEBlock((h // 4, w // 4), zc, zc // 2, cs)
        self.sp5 = SPADEBlock((h // 2, w // 2), zc // 2, zc // 4, cs)
        self.sp6 = SPADEBlock((h, w), zc // 4, zc // 8, cs)
        self.out = Conv(zc // 8, cb, 1, 1, 0, True)
        self.out_act = out_act

    def forward(self, si, mid, types, q):
        h = self.sp4(si, mid, types, q)
        h = self.sp5(si, up2(h), types, q)
        h = self.sp6(si, up2(h), types, q)
        return act(self.out(h, types, q), self.out_act)


class SpatialAttention(nn.Module):
    def __init__(self, ci, gc, inter):
        super().__init__()
        self.W_x = Conv(ci, inter, 2, 2, 0, bias=False)
        self.W_g = Conv(gc, inter, 1)
        self.W_psi = Conv(inter, 1, 1)
        self.W_out = nn.ModuleList([Conv(ci, ci, 1), BN(ci)])

    def forward(self, x, g, groups, q):
        xp = self.W_x(x, q=q)
        gp = resize(self.W_g(g, q=q), xp.shape[-2:], False)
        alpha = torch.sigmoid(self.W_psi(F.relu(xp + gp), q=q))
        alpha = resize(alpha, x.shape[-2:], False)
        return self.W_out[1](self.W_out[0](alpha * x, q=q), groups)


class OutputDecoderUSA(nn.Module):
    """'U+SA': a short U-Net (first_num_ch 64) whose skips pass through
    spatial attention gates."""

    def __init__(self, ci, co, out_act, f=64):
        super().__init__()
        self.down_1 = nn.ModuleList([Conv(ci, f, 4, 2, 1)])
        self.down_2 = DownBlock(f, 2 * f, False, old=True)
        self.down_3 = DownBlock(2 * f, 4 * f, False, old=True)
        self.down_4 = DownBlock(4 * f, 8 * f, False, old=True)
        self.down_5 = DownBlock(8 * f, 8 * f, False, old=True)
        self.att_4 = SpatialAttention(8 * f, 8 * f, 8 * f)
        self.up_4 = UpBlock(8 * f, 8 * f, False, old=True)
        self.att_3 = SpatialAttention(4 * f, 16 * f, 4 * f)
        self.up_3 = UpBlock(16 * f, 4 * f, False, old=True)
        self.att_2 = SpatialAttention(2 * f, 8 * f, 2 * f)
        self.up_2 = UpBlock(8 * f, 2 * f, False, old=True)
        self.att_1 = SpatialAttention(f, 4 * f, f)
        self.up_1 = UpBlock(4 * f, f, False, old=True)
        self.output = UpBlock(2 * f, co, False, last=True, old=True)
        self.out_act = out_act

    def forward(self, x, groups, q):
        d1 = F.leaky_relu(self.down_1[0](x, q=q), 0.2)
        d2 = self.down_2(d1, None, groups, q)
        d3 = self.down_3(d2, None, groups, q)
        d4 = self.down_4(d3, None, groups, q)
        d5 = self.down_5(d4, None, groups, q)
        u = self.up_4(self.att_4(d4, d5, groups, q), d5, None, groups, q)
        u = self.up_3(self.att_3(d3, u, groups, q), u, None, groups, q)
        u = self.up_2(self.att_2(d2, u, groups, q), u, None, groups, q)
        u = self.up_1(self.att_1(d1, u, groups, q), u, None, groups, q)
        return act(self.output(None, u, None, groups, q), self.out_act)


def to_nchw(x):
    m, b, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(m * b, c, h, w)


def from_nchw(x, groups):
    n, c, h, w = x.shape
    return x.reshape(groups, n // groups, c, h, w).permute(0, 1, 3, 4, 2)


def check_supported(cfg: dict) -> None:
    """Raise on a configuration this reference does not implement."""
    others = cfg.get("others", {})
    want = {"is_cond": True, "is_distri_z": False, "shared_ana_enc": True,
            "shared_mod_enc": True, "shared_inp_dec": False,
            "fuse_method": "mean", "target_model_name": "U+SA",
            "lambda_adv_s": 0.0, "lambda_kl": 0.0,
            "s_compact_method": "max", "s_sim_method": "cosine"}
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if others.get("mod_enc_s") or others.get("old") \
            or others.get("ana_dec_act", "softmax") != "softmax" \
            or not others.get("softmax_remove_mask", False):
        bad["others"] = others
    if cfg.get("dataset_name") == "BraTS" and (
            cfg.get("lambda_recon_y", 0) > 0
            or cfg.get("lambda_recon_y_fused", 0) > 0):
        bad["segmentation losses"] = True
    if bad:
        raise ValueError(f"the reference does not implement {bad}")


class Reference(nn.Module):
    """The model of a benchmark configuration (a dict of the YAML keys).
    ``checkpointed`` recomputes each encoder and decoder call in the
    backward pass, so that a float32 training step at the benchmark's
    batch fits on the card beside the volume cache; the arithmetic is
    the same."""

    def __init__(self, cfg: dict, quant: Precision = F32,
                 checkpointed: bool = False):
        super().__init__()
        check_supported(cfg)
        M = len(cfg["contrast_list"])
        cb = 2 * cfg["block_size"] + 1
        hw = (cfg["input_height"], cfg["input_width"])
        cs, z = cfg["s_num_ch"], cfg["z_size"]
        in_act = "softplus" if cfg["norm_type"] == "mean" else "no"
        out_act = "no" if (cfg["dataset_name"] == "BraTS"
                           or cfg["norm_type"] == "z-score") else "softplus"
        self.M, self.q, self.checkpointed = M, quant, checkpointed
        self.anatomy_encoder_enc_list = nn.ModuleList([AnatomyEnc(cb)])
        self.anatomy_encoder_dec = AnatomyDec(cs)
        self.modality_encoder_list = nn.ModuleList([ModalityEnc(cb, hw, z)])
        self.input_decoder_list = nn.ModuleList(
            [SPADENotShared(hw, cb, cs, in_act) for _ in range(M)]
            + [SPADEShared(hw, z, cs)])
        self.output_decoder = OutputDecoderUSA(cs, cfg["out_num_ch"],
                                               out_act)

    def _run(self, fn, *args):
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def types(self, device):
        return torch.arange(1, self.M + 1, dtype=torch.float32,
                            device=device)

    def encode_anatomy(self, xf, mask_img):
        """xf [M*B, Cb, H, W] -> s [M*B, Cs, H, W]: softmax over a
        100 * mask_img background channel and the logits, background
        dropped."""
        t = self.types(xf.device)

        def body(xf, mask_img):
            enc = self.anatomy_encoder_enc_list[0](xf, t, self.q)
            logits = self.anatomy_encoder_dec(enc, t, self.q)
            bg = (100.0 * mask_img)[:, None].repeat(self.M, 1, 1, 1)
            return torch.softmax(torch.cat([bg, logits], 1), 1)[:, 1:]
        return self._run(body, xf, mask_img)

    def encode_modality(self, xf):
        t = self.types(xf.device)
        return self._run(lambda x: self.modality_encoder_list[0](x, t,
                                                                 self.q), xf)

    def decode_grid(self, sf, zf):
        """Every (anatomy i, modality j) decode -> [M_i, M_j*B, Cb, H, W]:
        the shared half on the whole grid (types 1+j), then the
        not-shared half of source i on its row."""
        M = self.M
        B = sf.shape[0] // M
        t = self.types(sf.device)
        s_pair = sf.reshape(M, 1, B, *sf.shape[1:]).expand(
            M, M, B, *sf.shape[1:]).reshape(M, M * B, *sf.shape[1:])
        z_pair = zf.reshape(1, M * B, -1).expand(M, M * B, zf.shape[-1])
        shared = self.input_decoder_list[M]
        mid = self._run(lambda s, z: shared(s, z, t.repeat(M), self.q),
                        s_pair.reshape(M * M * B, *sf.shape[1:]),
                        z_pair.reshape(M * M * B, -1))
        mid = mid.reshape(M, M * B, *mid.shape[1:])
        rows = []
        for i in range(M):
            half = self.input_decoder_list[i]
            rows.append(self._run(lambda s, m, h=half: h(s, m, t, self.q),
                                  s_pair[i], mid[i]))
        return torch.stack(rows)

    def fuse(self, s, mask):
        """Mean over the present modalities: s [M, B, Cs, H, W], mask
        [B, M] -> [B, Cs, H, W]."""
        m = mask.t()[:, :, None, None, None]
        return (s * m).sum(0) / torch.clamp_min(m.sum(0), 1e-8)

    def decode_y(self, sf, mask, per_modality: bool):
        M = self.M
        s = sf.reshape(M, -1, *sf.shape[1:])
        fused = self.fuse(s, mask)
        dec = self.output_decoder
        if not per_modality:
            return None, self._run(lambda x: dec(x, 1, self.q), fused)
        stacked = torch.cat([s[i] for i in range(M)] + [fused])
        y = self._run(lambda x: dec(x, M + 1, self.q), stacked)
        n = M * s.shape[1]
        return y[:n], y[n:]

    def forward_train(self, x, mask, mask_img, eps, compute_y: bool):
        """The training forward (reference main_missing.py:175-190,
        228-231): x [M, B, H, W, Cb]; eps [M, B, z], the standard normal of
        z's sampling.  Returns s, z, z_mean, x_fake_grid [M, M, B, H, W,
        Cb], y_fake_list / y_fake_fused with ``compute_y``, z_mean_new."""
        M, B = x.shape[:2]
        xf = to_nchw(x)
        sf = self.encode_anatomy(xf, mask_img)
        zm, zv = (t.reshape(M, B, -1) for t in self.encode_modality(xf))
        z = zm + eps * torch.exp(0.5 * zv)
        grid = self.decode_grid(sf, z.reshape(M * B, -1))
        out = {"s": from_nchw(sf, M), "z": z, "z_mean": zm,
               "x_fake_grid": grid.reshape(M, M, B, *grid.shape[2:])
               .permute(0, 1, 2, 4, 5, 3)}
        if compute_y:
            y_list, y_fused = self.decode_y(sf, mask, True)
            out["y_fake_list"] = from_nchw(y_list, M)
            out["y_fake_fused"] = y_fused.permute(0, 2, 3, 1)
        diag = torch.cat([grid[i, i * B:(i + 1) * B] for i in range(M)])
        with torch.no_grad():       # the BatchNorms' running statistics
            self.encode_anatomy(diag, mask_img)
        out["z_mean_new"] = self.encode_modality(diag)[0].reshape(M, B, -1)
        return out

    @torch.no_grad()
    def calibrate(self, x, mask, mask_img):
        """Set every BatchNorm's running statistics to those of its input
        on this batch, as training would leave them for such data, through
        one eval-mode imputation pass from source 0."""
        bns = [m for m in self.modules() if isinstance(m, BN)]
        for m in bns:
            m.calibrating = True
        try:
            self.eval()
            self.synthesize(x, mask, mask_img, 0)
        finally:
            for m in bns:
                m.calibrating = False

    def synthesize(self, x, mask, mask_img, source: int):
        """Missing-modality imputation from the anatomy of ``source``:
        (x_hat [M, B, H, W, Cb], y [B, H, W, out])."""
        M, B = x.shape[:2]
        xf = to_nchw(x)
        sf = self.encode_anatomy(xf, mask_img)
        zf = self.encode_modality(xf)[0]
        t = self.types(x.device)
        s_src = sf[source * B:(source + 1) * B].repeat(M, 1, 1, 1)
        mid = self.input_decoder_list[M](s_src, zf, t, self.q)
        x_hat = self.input_decoder_list[source](s_src, mid, t, self.q)
        y = self.decode_y(sf, mask, False)[1]
        return from_nchw(x_hat, M), y.permute(0, 2, 3, 1)
