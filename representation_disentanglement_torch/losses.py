"""The loss zoo of the JAX package's 2D step (JAX ``losses.py:28-314``),
branch-free: the shipped five, the y losses (L1/L2 reconstruction, or the
BraTS segmentation loss), the KL losses, the adversarial loss and the VGG
similarity paths (``s_compact_method: 'vgg'``, ``s_sim_method:
'perceptual'``, models/vgg.py); and the test-time z retrieval (JAX
``losses.py:321-332``).

Every loss keeps the reference's mask semantics (src/model.py:3260-3557):
a modality's term contributes only when its mask column has a present
sample in the batch, masked means divide by the mask sum, and the outer
average divides by the number of contributing terms.  That is
``where``-gated arithmetic, as in the JAX package, so an all-missing mask
gives exactly 0.0 and never NaN, in the value and in the gradient.

Layouts are the JAX package's: per-modality tensors carry a leading
modality axis (x: [M, B, H, W, C], z: [M, B, zdim]), the decode grid is
[M_i, M_j, B, H, W, C], masks are [B, M].  Tensors may be permuted views
of the model's NCHW activations; the reductions take them as they are.

Inside a ``parallel.mesh.data_parallel`` scope each rank holds B/N rows of
the global batch; every loss first reduces its images to per-sample terms
(the [M, B] reconstruction errors, the segmentation sums, the compacted s
vectors, z, the discriminator's logits) and gathers those and the masks
over the ranks (``gather_rows``, differentiable), then reduces the global
batch as unsharded, so that every rank holds the global loss (the JAX DP
step's semantics, one computation over the global batch).  Outside a scope
the gathers are the identity.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from representation_disentanglement_torch.models.vgg import (
    compact_s_vgg, perceptual_similarity)
from representation_disentanglement_torch.ops import avg_pool, max_pool
from representation_disentanglement_torch.parallel.mesh import gather_rows


def _safe_div(num, den):
    """num / den where den > 0, else 0; the inner where keeps the gradient
    of the untaken branch finite."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def per_sample_recon(gt: torch.Tensor, out: torch.Tensor, p: int):
    """compute_recon_loss (src/model.py:3260-3266): per-sample mean over the
    last three dims (H, W, C), in f32."""
    diff = gt.float() - out.float()
    red = (-3, -2, -1)
    if p == 1:
        return diff.abs().mean(dim=red)
    return diff.square().mean(dim=red)


def recon_loss_x(gt, x_fake, mask, p: int = 2):
    """compute_recon_loss_x_list (src/model.py:3315-3325).
    gt, x_fake: [M, B, H, W, C]; mask: [B, M]."""
    r = gather_rows(per_sample_recon(gt, x_fake, p), 1)       # [M, B]
    m = gather_rows(mask, 0).t().float()
    msum = m.sum(dim=1)
    per_mod = _safe_div((m * r).sum(dim=1), msum)
    present = (msum > 0).float()
    return _safe_div((per_mod * present).sum(), present.sum())


def recon_loss_x_mix(gt, grid, mask, p: int = 2):
    """compute_recon_loss_x_mix_list (src/model.py:3327-3341): grid[i, j]
    against gt[j] under mask_i * mask_j, off the diagonal.

    Deliberate fix of a reference bug, as in the JAX package: the reference
    does not advance its reconstruction index past an empty pair
    (src/model.py:3335-3338), so every later pair meets the wrong
    reconstruction.  Here grid[i, j] always pairs with gt[j] and an empty
    pair contributes nothing; identical whenever no modality is absent
    across the whole batch."""
    M = grid.shape[0]
    r = gather_rows(per_sample_recon(gt[None], grid, p), 2)   # [M_i, M_j, B]
    m = gather_rows(mask, 0).t().float()
    off_diag = (1.0 - torch.eye(M, device=m.device))[:, :, None]
    mm = m[:, None, :] * m[None, :, :] * off_diag
    mmsum = mm.sum(dim=2)
    per_pair = _safe_div((mm * r).sum(dim=2), mmsum)
    contributing = (mmsum > 0).float()
    return _safe_div((per_pair * contributing).sum(), contributing.sum())


def recon_loss_y(gt, y, p: int = 2):
    """compute_recon_loss_y (src/model.py:3280-3285)."""
    return gather_rows(per_sample_recon(gt, y, p), 0).mean()


def recon_loss_y_list(gt, y_list, mask, p: int = 2):
    """compute_recon_loss_y_list (src/model.py:3268-3278).
    gt: [B, H, W, C]; y_list: [M, B, H, W, C]; mask: [B, M]."""
    r = gather_rows(per_sample_recon(gt[None], y_list, p), 1)  # [M, B]
    m = gather_rows(mask, 0).t().float()
    msum = m.sum(dim=1)
    per_mod = _safe_div((m * r).sum(dim=1), msum)
    present = (msum > 0).float()
    return _safe_div((per_mod * present).sum(), present.sum())


SEG_CLASS_WEIGHT = (1.0, 5.0, 5.0, 5.0)


def segmentation_loss_y(gt, y, weight=SEG_CLASS_WEIGHT):
    """compute_segmentation_loss_y (src/model.py:3287-3297): class-weighted
    cross entropy, whose mean divides by the summed per-pixel weights (what
    ``F.cross_entropy(weight=...)`` does), plus the 3-class soft Dice on
    the f32 softmax.  gt: [B, H, W, 1] float labels 0-3; y: [B, H, W, 4]
    logits."""
    labels = gt[..., 0].long()                                # [B, H, W]
    logits = y.float().movedim(-1, 1)                         # [B, 4, H, W]
    w = torch.tensor(weight, dtype=torch.float32, device=y.device)
    prob = torch.softmax(logits, dim=1)
    # per sample: the weighted NLL and its weights' sums (the weighted
    # mean of F.cross_entropy), and the Dice numerators and denominators;
    # the global batch's sums under a data-parallel scope
    wl = w[labels]
    terms = [(wl * F.cross_entropy(logits, labels, reduction="none"))
             .sum(dim=(1, 2)), wl.sum(dim=(1, 2))]
    for i in range(1, 4):
        gt_i = (labels == i).float()
        terms += [(prob[:, i] * gt_i).sum(dim=(1, 2)),
                  (prob[:, i].square() + gt_i.square()).sum(dim=(1, 2))]
    sums = gather_rows(torch.stack(terms, 1), 0).sum(0)
    loss_dice = torch.zeros((), device=y.device)
    for i in range(1, 4):
        loss_dice = loss_dice + (1.0 - 2.0 * sums[2 * i]
                                 / (sums[2 * i + 1] + 1e-6))
    return sums[0] / sums[1] + loss_dice / 3.0


def segmentation_loss_y_list(gt, y_list, mask, weight=SEG_CLASS_WEIGHT):
    """compute_segmentation_loss_y_list (src/model.py:3299-3313).  As in
    the reference, each modality's term is unmasked: the mask only decides
    whether a modality counts."""
    present = (gather_rows(mask, 0).float().sum(dim=0) > 0).float()  # [M]
    losses = torch.stack([segmentation_loss_y(gt, y_list[i], weight)
                          for i in range(y_list.shape[0])])
    return _safe_div((losses * present).sum(), present.sum())


def kl_loss_standard_list(z_mean, z_log_var, mask):
    """compute_kl_loss_list_standard (src/model.py:3343-3360): the KL to
    N(0, I) of every present (modality, sample), one masked mean, divided
    by M.  z_mean, z_log_var: [M, B, z]; mask: [B, M]."""
    zm, zv = z_mean.float(), z_log_var.float()
    kl = gather_rows(0.5 * (zv.exp() + zm.square() - 1.0 - zv).sum(dim=-1),
                     1)                                        # [M, B]
    m = gather_rows(mask, 0).t().float()
    return _safe_div((kl * m).sum(), m.sum()) / z_mean.shape[0]


def kl_loss_two_gaussian_list(z_mean, z_log_var, prior_mean, prior_log_var,
                              mask):
    """compute_kl_loss_list_two_gaussian (src/model.py:3372-3382): the KL
    to the learned per-modality prior.  Each modality's masked mean is
    summed and divided by M, not by the number of present modalities.
    prior_mean, prior_log_var: [M, z], broadcast over the batch."""
    zm, zv = z_mean.float(), z_log_var.float()
    pm = prior_mean.float()[:, None, :]
    pv = prior_log_var.float()[:, None, :]
    kl = 0.5 * (-1.0 + (pv - zv)
                + (zv.exp() + (zm - pm).square()) / pv.exp())   # [M, B, z]
    m = gather_rows(mask, 0).t().float()
    kl = gather_rows((kl * mask.t().float()[:, :, None]).sum(-1), 1)
    per_mod = _safe_div(kl.sum(dim=1), m.sum(dim=1))
    return per_mod.sum() / z_mean.shape[0]


def latent_z_loss(z_mean, z_mean_new, mask):
    """compute_latent_z_loss (src/model.py:3384-3394): masked L1 between the
    z means and their re-encoding; the divisor is the mask sum, not
    mask_sum * z_size (reference parity)."""
    diff = (z_mean.float() - z_mean_new.float()).abs()       # [M, B, z]
    m = gather_rows(mask, 0).t().float()
    msum = m.sum(dim=1)
    diff = gather_rows((diff * mask.t().float()[:, :, None]).sum(-1), 1)
    per_mod = _safe_div(diff.sum(dim=1), msum)
    present = (msum > 0).float()
    return _safe_div((per_mod * present).sum(), present.sum())


def compact_s(s: torch.Tensor, method: str = "max", vgg_ctx=None):
    """compute_compact_s (src/model.py:3448-3475): 16x16 pooling,
    flattened, or with ``method='vgg'`` the whole of VGG16's features
    pooled to [..., 512] (compute_compact_s_vgg, src/model.py:3460-3467;
    ``vgg_ctx`` from ``training.train.make_vgg_ctx``).
    s: [..., H, W, C] -> [..., D].

    Pools the NCHW view and flattens in the JAX order (h, w, c).  Only
    ``cosine`` reads the result, and cosine is invariant to a common
    permutation of both vectors, so the order matters only for comparing
    this function with the JAX one."""
    nchw = s.movedim(-1, -3)
    if method == "vgg":
        if vgg_ctx is None:
            raise ValueError(
                "s_compact_method='vgg' needs VGG16 weights: set cfg.vgg_npz "
                "(produce the npz with models.vgg.dump_torchvision_vgg16)")
        vec = compact_s_vgg(nchw.reshape(-1, *nchw.shape[-3:]),
                            vgg_ctx["pre_weight"], vgg_ctx["pre_bias"],
                            vgg_ctx["vgg_params"])
        return vec.reshape(*s.shape[:-3], vec.shape[-1])
    if method == "max":
        pooled = max_pool(nchw, 16)
    elif method == "mean":
        pooled = avg_pool(nchw, 16)
    else:
        raise ValueError(f"unknown s_compact_method {method!r}")
    return pooled.movedim(-3, -1).reshape(*s.shape[:-3], -1)


def cosine(x, y):
    """compute_cosine (src/model.py:3407-3415), with its epsilon scheme."""
    x, y = x.float(), y.float()
    xn = torch.clamp_min(torch.sqrt(x.square().sum(-1) + 1e-8), 1e-8)
    yn = torch.clamp_min(torch.sqrt(y.square().sum(-1) + 1e-8), 1e-8)
    return (x * y).sum(-1) / (xn * yn)


def _roll1(a):
    """torch.cat([a[1:], a[:1]]) == roll by -1 along axis 0."""
    return torch.roll(a, -1, 0)


def similarity_s_loss(s, mask, pair: Sequence[int], margin: float = 0.1,
                      compact_method: str = "max",
                      sim_method: str = "cosine", vgg_ctx=None):
    """compute_similarity_s_loss (src/model.py:3478-3535): the anatomy of
    one subject across the modalities of ``pair`` should be closer than
    that of different subjects (the batch rolled by one).  ``pair`` is the
    (i, j) drawn on the host (``training.train.draw_pairs``).
    s: [M, B, H, W, Cs]; mask: [B, M].

    ``sim_method='perceptual'`` (src/model.py:3525-3532): the VGG
    perceptual score is one scalar for the pair's batch, so the reference's
    masked mean is -score whenever the pair mask has a present sample, else
    0 (JAX losses.py:226-260)."""
    if s.shape[0] == 1:
        return torch.zeros((), device=s.device)
    i, j = int(pair[0]), int(pair[1])
    si, sj = s[i], s[j]
    gmask = gather_rows(mask, 0)
    mask_i, mask_j = gmask[:, i].float(), gmask[:, j].float()
    mask_mix = mask_i * mask_j * _roll1(mask_i)
    if sim_method == "perceptual":
        if vgg_ctx is None:
            raise ValueError("s_sim_method='perceptual' needs VGG16 "
                             "weights: set cfg.vgg_npz")
        sim = perceptual_similarity(
            si.movedim(-1, -3), sj.movedim(-1, -3), vgg_ctx["pre_weight"],
            vgg_ctx["pre_bias"], vgg_ctx["vgg_params"])
        return torch.where(mask_mix.sum() > 0, -sim, torch.zeros_like(sim))
    if sim_method != "cosine":
        raise ValueError(f"unknown s_sim_method {sim_method!r}")
    si_c = gather_rows(compact_s(si, compact_method, vgg_ctx), 0)
    sj_c = gather_rows(compact_s(sj, compact_method, vgg_ctx), 0)
    # compact_s is per sample: the rolled batch's codes are the rolled
    # codes, so the roll pairs across the ranks' blocks of the global batch
    si_perm_c = _roll1(si_c)
    sim = cosine(si_c, sj_c)
    sim_mix = cosine(si_perm_c, si_c)
    hinge = torch.clamp_min(margin - sim + sim_mix, 0.0)
    return _safe_div((mask_mix * hinge).sum(), mask_mix.sum())


def similarity_z_loss(z, mask, margin: float = 0.1):
    """compute_similarity_z_loss (src/model.py:3537-3557): over all pairs
    i < j, z across modalities should differ and z across subjects of one
    modality should match.  z: [M, B, zdim]; mask: [B, M]."""
    M = z.shape[0]
    if M == 1:
        return torch.zeros((), device=z.device)
    z = gather_rows(z, 1)
    m = gather_rows(mask, 0).t().float()
    total = torch.zeros((), device=z.device)
    count = torch.zeros((), device=z.device)
    for i in range(M - 1):
        zi = z[i]
        cos_mix = cosine(zi, _roll1(zi))
        mask_i_perm = _roll1(m[i])
        for j in range(i + 1, M):
            mm = m[i] * m[j] * mask_i_perm
            hinge = torch.clamp_min(margin - cos_mix + cosine(zi, z[j]), 0.0)
            term = _safe_div((mm * hinge).sum(), mm.sum())
            has = (mm.sum() > 0).float()
            total = total + term * has
            count = count + has
    return _safe_div(total, count)


def _bce_with_logits(logits, target: float):
    return (torch.clamp_min(logits, 0.0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def adversarial_loss(d_logits, mask_pair):
    """compute_adversarial_loss (src/model.py:3559-3587) from the
    discriminator's logits for the pair: d_logits, mask_pair: [2, B].
    Returns (d_loss, g_loss).  Quirk Q4 kept: the generator term of the
    second modality is its discriminator term (both target ones,
    src/model.py:3579-3580)."""
    mask_pair = gather_rows(mask_pair, 1)
    d_logits = gather_rows(d_logits, 1)
    m0, m1 = mask_pair[0].float(), mask_pair[1].float()
    d0, d1 = d_logits[0].float(), d_logits[1].float()
    d_loss_0 = _safe_div((m0 * _bce_with_logits(d0, 0.0)).sum(), m0.sum())
    g_loss_0 = _safe_div((m0 * _bce_with_logits(d0, 1.0)).sum(), m0.sum())
    d_loss_1 = _safe_div((m1 * _bce_with_logits(d1, 1.0)).sum(), m1.sum())
    g_loss_1 = d_loss_1
    return 0.5 * (d_loss_0 + d_loss_1), 0.5 * (g_loss_0 + g_loss_1)


# ---------------------------------------------------------------------------
# z retrieval (test-time imputation, src/model.py:3396-3405)
# ---------------------------------------------------------------------------

def nearest_neighbour_z_by_s(s_bank, z_bank, s_query):
    """For each query compact-anatomy key, the z of the most cosine-similar
    bank entry; on a tie the first bank index wins, as ``jnp.argmax``.
    s_bank: [N, D], z_bank: [N, z], s_query: [Q, D] -> [Q, z]."""
    sims = cosine(s_query[:, None, :], s_bank[None, :, :])     # [Q, N]
    return z_bank[torch.argmax(sims, dim=1)]


def mean_z(z_bank):
    """The bank's mean z: [N, z] -> [z]."""
    return z_bank.mean(dim=0)
