"""Plain float32 reference of NVNet3D, Myronenko's autoencoder-regularized
3D U-Net (A. Myronenko, "3D MRI brain tumor segmentation using
autoencoder regularization", arXiv:1810.11654), one training step of it,
and the augmented crop its loader draws.

Written from the paper and from the reference torch modules it is shipped
as (ouyangjiahong/representation-disentanglement, src/model.py:1856-2060:
``BasicBlock``, ``VAEBranch``, ``UNet3D``, ``NVNet3D``) in plain PyTorch
(``F.conv3d``, ``F.group_norm``, nearest upsampling by indexing, linear
layers): no fused op, nothing of the measured package.  Parameters live in
one dictionary under the reference model's ``state_dict()`` names
(``unet.conv1b.gn1.weight``, ``vae_branch.reconstraction.0.weight`` (sic),
...), so that one weight dictionary made by the benchmark loads into both
sides.

The block is the paper's: GroupNorm(8), ReLU, 3x3x3 convolution, twice,
plus the identity skip.  The encoder has four levels of 32, 64, 128 and
256 filters at the paper's width (1, 2, 2 and 4 blocks, strided 3x3x3
convolutions between them); the decoder a 1x1x1 convolution, a 2x
upsampling and the encoder level added, then one block, per level; the
output a 1x1x1 convolution to the three tumour classes.  The loss is the
soft Dice of sigmoid outputs plus 0.1 L2 plus 0.1 KL, and the step clips
the gradient to a global norm of 1 and takes one Adam step (amsgrad, L2
weight decay added to the gradient, ``benchmark/reference/train.py``).

Departures from the paper, each as the reference modules have it:

- the VAE's reduction: GroupNorm, ReLU and a 3x3x3 convolution to the
  squeeze width, then a global average pool, the mean read by a linear
  layer from the first half of the channels and the log variance by
  another from the second half (the paper: a strided convolution to 16
  channels and one dense layer to 256 numbers);
- the VAE's decoder: a linear layer from the latent to 8f x H/16 x W/16 x
  D/16 and a ReLU, a 1x1x1 convolution and upsampling, then per level a
  3x3x3 convolution, upsampling and one block, a 1x1x1 convolution to the
  contrasts (the paper: a dense layer to 16 channels, then 1x1x1
  convolutions and upsampling without the first ReLU);
- upsampling by nearest neighbour where the paper is trilinear;
- dropout: elementwise, keep 0.8, on the bottleneck's output in training
  (the paper: spatial dropout 0.2 after the first convolution);
- the classes are labels 1, 2 and 3 taken apart, where the paper's are
  the nested tumour regions; the L2 term is a mean over voxels and the
  KL is divided by one sample's voxels times contrasts;
- the gradient clip to a global norm of 1 and amsgrad are the recipe's,
  not the paper's (Adam at 1e-4 with L2 1e-5, batch 1, is);
- the crop is a fixed slab of depth where the paper crops at random, and
  its augmentation (a flip of the first spatial axis with probability
  0.5, intensity scale 1 +- 0.1 and shift +- 0.1, the smallest value
  pinned to -10) is the reference loader's (src/util.py:798-805).

Layouts: inputs [B, M, H, W, D], targets [B, 1, H, W, D] holding labels
0-3, kernels (O, I, kH, kW, kD).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.train import adam_amsgrad

GROUPS = 8
GN_EPS = 1e-5
KEEP = 0.8          # dropout keep probability on the bottleneck
KL_WEIGHT = RECON_WEIGHT = 0.1


def param_specs(cfg: dict) -> List[Tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every parameter in the reference model's
    order; fan_in 0 marks a GroupNorm's scale and shift."""
    f = cfg["init_channels"]
    sq = cfg["squeeze_channels"] or 4 * f
    m = len(cfg["contrast_list"])
    H, W, D = cfg["image_size"]
    out: List[Tuple[str, tuple, int]] = []

    def conv(name, ci, co, k=3):
        out.append((f"{name}.weight", (co, ci, k, k, k), ci * k ** 3))
        out.append((f"{name}.bias", (co,), ci * k ** 3))

    def gn(name, c):
        out.append((f"{name}.weight", (c,), 0))
        out.append((f"{name}.bias", (c,), 0))

    def block(name, c):
        gn(f"{name}.gn1", c)
        conv(f"{name}.conv1", c, c)
        gn(f"{name}.gn2", c)
        conv(f"{name}.conv2", c, c)

    def linear(name, i, o):
        out.append((f"{name}.weight", (o, i), i))
        out.append((f"{name}.bias", (o,), i))

    u = "unet."
    conv(u + "conv1a", m, f)
    block(u + "conv1b", f)
    conv(u + "ds1", f, 2 * f)
    block(u + "conv2a", 2 * f)
    block(u + "conv2b", 2 * f)
    conv(u + "ds2", 2 * f, 4 * f)
    block(u + "conv3a", 4 * f)
    block(u + "conv3b", 4 * f)
    conv(u + "ds3", 4 * f, 8 * f)
    for k in "abcd":
        block(u + f"conv4{k}", 8 * f)
    conv(u + "up4conva", 8 * f, 4 * f, 1)
    block(u + "up4convb", 4 * f)
    conv(u + "up3conva", 4 * f, 2 * f, 1)
    block(u + "up3convb", 2 * f)
    conv(u + "up2conva", 2 * f, f, 1)
    block(u + "up2convb", f)
    conv(u + "up1conv", f, 3, 1)
    v = "vae_branch."
    gn(v + "hidden_conv.0", 8 * f)
    conv(v + "hidden_conv.2", 8 * f, sq)
    linear(v + "mu_fc", sq // 2, sq // 2)
    linear(v + "logvar_fc", sq // 2, sq // 2)
    linear(v + "reconstraction.0", sq // 2,
           8 * f * (H // 16) * (W // 16) * (D // 16))
    conv(v + "vconv4.0", 8 * f, 8 * f, 1)
    for lvl, ci, co in ((3, 8 * f, 4 * f), (2, 4 * f, 2 * f),
                        (1, 2 * f, f)):
        conv(v + f"vconv{lvl}.0", ci, co)
        block(v + f"vconv{lvl}.2", co)
    conv(v + "vconv0", f, m, 1)
    return out


def _up(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of [B, C, H, W, D]: output index i reads
    input i // 2 on each spatial axis."""
    b, c, h, w, d = x.shape
    return x[:, :, :, None, :, None, :, None].expand(
        b, c, h, 2, w, 2, d, 2).reshape(b, c, 2 * h, 2 * w, 2 * d)


def forward(P: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
            gen: torch.Generator = None, train: bool = True):
    """x [B, M, H, W, D] -> (uout [B, 3, H, W, D] logits, vout [B, M, H, W,
    D], mu, logvar [B, squeeze / 2]).  In training with ``gen``: the
    dropout mask of the bottleneck (one ``bernoulli_`` at its shape), then
    the VAE's eps (one float32 ``normal_`` at the latent's shape), drawn in
    that order; otherwise z = mu and no dropout."""
    f = cfg["init_channels"]
    H, W, D = cfg["image_size"]

    def conv(n, h, stride=1, pad=1):
        return F.conv3d(h, P[n + ".weight"], P[n + ".bias"], stride=stride,
                        padding=pad)

    def gn(n, h):
        return F.group_norm(h, GROUPS, P[n + ".weight"], P[n + ".bias"],
                            GN_EPS)

    def block(n, h):
        r = conv(n + ".conv1", F.relu(gn(n + ".gn1", h)))
        return conv(n + ".conv2", F.relu(gn(n + ".gn2", r))) + h

    def linear(n, h):
        return h @ P[n + ".weight"].t() + P[n + ".bias"]

    u = "unet."
    c1 = block(u + "conv1b", conv(u + "conv1a", x))
    c2 = block(u + "conv2b", block(u + "conv2a",
                                   conv(u + "ds1", c1, stride=2)))
    c3 = block(u + "conv3b", block(u + "conv3a",
                                   conv(u + "ds2", c2, stride=2)))
    c4 = conv(u + "ds3", c3, stride=2)
    for k in "abcd":
        c4 = block(u + f"conv4{k}", c4)
    if train and gen is not None:
        mask = torch.empty_like(c4).bernoulli_(KEEP, generator=gen)
        c4 = torch.where(mask.bool(), c4 / KEEP, 0.0)
    u4 = block(u + "up4convb", _up(conv(u + "up4conva", c4, pad=0)) + c3)
    u3 = block(u + "up3convb", _up(conv(u + "up3conva", u4, pad=0)) + c2)
    u2 = block(u + "up2convb", _up(conv(u + "up2conva", u3, pad=0)) + c1)
    uout = conv(u + "up1conv", u2, pad=0)

    v = "vae_branch."
    h = conv(v + "hidden_conv.2", F.relu(gn(v + "hidden_conv.0", c4)))
    h = h.mean(dim=(2, 3, 4))
    half = h.shape[1] // 2
    mu = linear(v + "mu_fc", h[:, :half])
    logvar = linear(v + "logvar_fc", h[:, half:])
    z = mu
    if train and gen is not None:
        eps = torch.empty(mu.shape, dtype=torch.float32,
                          device=mu.device).normal_(generator=gen)
        z = mu + eps * torch.exp(0.5 * logvar)
    r = F.relu(linear(v + "reconstraction.0", z)).view(
        -1, 8 * f, H // 16, W // 16, D // 16)
    r = _up(conv(v + "vconv4.0", r, pad=0))
    for lvl in (3, 2, 1):
        r = block(v + f"vconv{lvl}.2", _up(conv(v + f"vconv{lvl}.0", r)))
    return uout, conv(v + "vconv0", r, pad=0), mu, logvar


def losses(uout, vout, mu, logvar, seg, x) -> Dict[str, torch.Tensor]:
    """The loss of one batch and its terms: soft Dice over the three
    classes (label i + 1 against sigmoid channel i, eps 1e-6), the mean
    squared reconstruction error, and the KL summed over the latent,
    meaned over the batch and divided by one sample's voxels times
    contrasts."""
    p = torch.sigmoid(uout)
    dice = 0.0
    for i in range(uout.shape[1]):
        gt = (seg[:, 0] == i + 1).float()
        dice = dice + 1.0 - 2.0 * (p[:, i] * gt).sum() / (
            (p[:, i].square() + gt.square()).sum() + 1e-6)
    dice = dice / uout.shape[1]
    recon = (vout - x).square().mean()
    kl = (logvar.exp() + mu.square() - 1.0 - logvar).sum(-1).mean() \
        / x[0].numel()
    return {"all": dice + RECON_WEIGHT * recon + KL_WEIGHT * kl,
            "dice_loss": dice, "vae_recon": recon, "kl": kl}


def crop(vols, tgts, subj: int, start: int, depth: int, flip: bool,
         scale: float, shift: float):
    """One augmented crop from the cache tensors (vols [S, M, Dz, H, W],
    tgts [S, Dz, H, W]) by plain indexing: the slab [start, start +
    depth) of subject ``subj`` as inputs [M, H, W, depth] float32 and
    targets [1, H, W, depth] (label 4 read as 3); with ``flip`` both
    reversed along H; the inputs times ``scale`` plus ``shift``, then every
    voxel equal to their smallest value set to -10."""
    x = vols[subj, :, start:start + depth].float().permute(0, 2, 3, 1)
    t = tgts[subj, start:start + depth].float().permute(1, 2, 0)
    t = torch.where(t == 4, 3.0, t)
    if flip:
        x, t = x.flip(1), t.flip(0)
    x = x * scale + shift
    x = torch.where(x == x.min(), -10.0, x)
    return x.contiguous(), t[None].contiguous()


def train_steps(P: Dict[str, torch.Tensor], cfg: dict,
                steps: Sequence[Sequence[dict]], gen: torch.Generator,
                clip: float = 1.0, wd: float = 1e-5) -> dict:
    """Optimizer steps on the parameters ``P`` (in place), each a list of
    microbatches (``inputs``, ``targets``): per microbatch the gradient of
    its loss over the microbatch count is added to the sum; the sum is
    clipped to global norm ``clip`` (scale min(1, clip / (norm + 1e-6)))
    and one Adam step taken.  Returns per step the loss and its terms (the
    microbatches' means) and the gradients the first update read."""
    names = list(P)
    params = [P[n] for n in names]
    state, out = {}, {"loss": [], "terms": [], "grad1": None}
    for micro in steps:
        acc = [torch.zeros_like(p) for p in params]
        terms: Dict[str, float] = {}
        for mb in micro:
            l = losses(*forward(P, cfg, mb["inputs"], gen), mb["targets"],
                       mb["inputs"])
            grads = torch.autograd.grad(l["all"] / len(micro), params)
            with torch.no_grad():
                for s, g in zip(acc, grads):
                    s.add_(g)
            for k, v in l.items():
                terms[k] = terms.get(k, 0.0) + float(v.detach()) / len(micro)
            del l, grads
        with torch.no_grad():
            total = torch.sqrt(sum(g.square().sum() for g in acc))
            scale = torch.clamp_max(clip / (total + 1e-6), 1.0)
            for s in acc:
                s.mul_(scale)
        seen = adam_amsgrad(params, acc, state, cfg["lr"], wd)
        if out["grad1"] is None:
            out["grad1"] = {n: float(g.norm()) for n, g in zip(names, seen)}
        out["loss"].append(terms["all"])
        out["terms"].append(terms)
    return out

