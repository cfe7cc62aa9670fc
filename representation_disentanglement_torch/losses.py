"""The shipped loss set (JAX ``losses.py:28-295``), branch-free.

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
"""

from __future__ import annotations

from typing import Sequence

import torch

from representation_disentanglement_torch.ops import avg_pool, max_pool


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
    r = per_sample_recon(gt, x_fake, p)                       # [M, B]
    m = mask.t().float()
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
    r = per_sample_recon(gt[None], grid, p)                   # [M_i, M_j, B]
    m = mask.t().float()
    off_diag = (1.0 - torch.eye(M, device=m.device))[:, :, None]
    mm = m[:, None, :] * m[None, :, :] * off_diag
    mmsum = mm.sum(dim=2)
    per_pair = _safe_div((mm * r).sum(dim=2), mmsum)
    contributing = (mmsum > 0).float()
    return _safe_div((per_pair * contributing).sum(), contributing.sum())


def latent_z_loss(z_mean, z_mean_new, mask):
    """compute_latent_z_loss (src/model.py:3384-3394): masked L1 between the
    z means and their re-encoding; the divisor is the mask sum, not
    mask_sum * z_size (reference parity)."""
    diff = (z_mean.float() - z_mean_new.float()).abs()       # [M, B, z]
    m = mask.t().float()
    msum = m.sum(dim=1)
    per_mod = _safe_div((diff * m[:, :, None]).sum(dim=(1, 2)), msum)
    present = (msum > 0).float()
    return _safe_div((per_mod * present).sum(), present.sum())


def compact_s(s: torch.Tensor, method: str = "max"):
    """compute_compact_s (src/model.py:3448-3475): 16x16 pooling,
    flattened.  s: [..., H, W, C] -> [..., D].

    Pools the NCHW view and flattens in the JAX order (h, w, c).  Only
    ``cosine`` reads the result, and cosine is invariant to a common
    permutation of both vectors, so the order matters only for comparing
    this function with the JAX one."""
    nchw = s.movedim(-1, -3)
    if method == "max":
        pooled = max_pool(nchw, 16)
    elif method == "mean":
        pooled = avg_pool(nchw, 16)
    else:
        raise NotImplementedError(
            f"s_compact_method {method!r} is not ported yet (ROADMAP.md, "
            "queue 1, item 14)")
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
                      compact_method: str = "max"):
    """compute_similarity_s_loss (src/model.py:3478-3535), cosine method:
    the anatomy of one subject across the modalities of ``pair`` should be
    closer than that of different subjects (the batch rolled by one).
    ``pair`` is the (i, j) drawn on the host (``training.train.draw_pairs``).
    s: [M, B, H, W, Cs]; mask: [B, M]."""
    if s.shape[0] == 1:
        return torch.zeros((), device=s.device)
    i, j = int(pair[0]), int(pair[1])
    si, sj = s[i], s[j]
    mask_i, mask_j = mask[:, i].float(), mask[:, j].float()
    mask_mix = mask_i * mask_j * _roll1(mask_i)
    si_c = compact_s(si, compact_method)
    sj_c = compact_s(sj, compact_method)
    si_perm_c = compact_s(_roll1(si), compact_method)
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
    m = mask.t().float()
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
