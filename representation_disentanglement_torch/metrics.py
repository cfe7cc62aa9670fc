"""Evaluation metrics with skimage semantics, on the device (JAX
``metrics.py``).

The reference's evaluation (src/util.py:928-992) shifts target and
prediction by their own minima, takes ``data_range`` as the shifted
target's maximum and scores each slice with skimage's MSE, PSNR and SSIM,
and BraTS label maps with per-class Dice/IoU (+1 smoothing).  SSIM follows
``skimage.metrics.structural_similarity``'s defaults for 2D float input:
uniform 7x7 windows, K1 0.01, K2 0.03, sample covariance, a border of 3
cropped; inside that border skimage's filtered values are the means over
the VALID windows, computed here with ``avg_pool2d``.

Everything runs in f32, batched over the slices, on the tensors' device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def _valid_window_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    """Means over every valid win x win window of [B, H, W]."""
    return F.avg_pool2d(x[:, None], win, stride=1)[:, 0]


def ssim_single(target: torch.Tensor, pred: torch.Tensor, data_range,
                win: int = 7, k1: float = 0.01, k2: float = 0.03):
    """SSIM of min-shifted slices (src/util.py:959-961): target and pred
    [H, W] (one slice, a scalar result) or [B, H, W] with ``data_range`` a
    scalar or [B] (a [B] result)."""
    t, p = target.float(), pred.float()
    single = t.dim() == 2
    if single:
        t, p = t[None], p[None]
    dr = torch.as_tensor(data_range, dtype=torch.float32,
                         device=t.device).reshape(-1, 1, 1)
    n = win * win
    cov_norm = n / (n - 1.0)                       # sample covariance
    ux = _valid_window_mean(t, win)
    uy = _valid_window_mean(p, win)
    uxx = _valid_window_mean(t * t, win)
    uyy = _valid_window_mean(p * p, win)
    uxy = _valid_window_mean(t * p, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * dr) ** 2
    c2 = (k2 * dr) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    out = ((a1 * a2) / (b1 * b2)).mean(dim=(-2, -1))
    return out[0] if single else out


def recon_metrics_device(target: torch.Tensor, pred: torch.Tensor):
    """(ssim, psnr, mse), each [B], of [B, H, W] slices: both shifted by
    their own minimum, data_range the shifted target's maximum
    (src/util.py:955-978).  The key the callers file mse under is
    ``rmse``, as the reference's is."""
    t, p = target.float(), pred.float()
    t = t - t.amin(dim=(1, 2), keepdim=True)
    p = p - p.amin(dim=(1, 2), keepdim=True)
    rng = t.amax(dim=(1, 2))
    mse = (t - p).square().mean(dim=(1, 2))
    psnr = 10.0 * torch.log10(rng.square() / mse)
    return ssim_single(t, p, rng), psnr, mse


def seg_metrics_device(target: torch.Tensor, pred: torch.Tensor):
    """(dice, iou), each [B], over classes 1-3 with +1 smoothing and a 0.5
    threshold on the prediction (src/util.py:946-953, 980-992).  target
    [B, H, W] labels; pred [B, H, W, >=3], channel i for class i+1.  The
    counts are exact in f32 (fewer than 2^24 pixels per slice)."""
    t, p = target.float(), pred.float()
    dice, iou = [], []
    for i in range(3):
        gt = (t == i + 1).float()
        pr = (p[..., i] > 0.5).float()
        inter = (gt * pr).sum(dim=(1, 2))
        union = torch.maximum(gt, pr).sum(dim=(1, 2))
        dice.append((2.0 * inter + 1) / (gt.sum(dim=(1, 2))
                                         + pr.sum(dim=(1, 2)) + 1))
        iou.append((inter + 1) / (union + 1))
    return torch.stack(dice).mean(0), torch.stack(iou).mean(0)


def compute_reconstruction_metrics(target, pred,
                                   device=None) -> Dict[str, list]:
    """Host wrapper (src/util.py:935-944) over channel 0 of each sample:
    target, pred [B, H, W, C] (NHWC) -> {"ssim", "psnr", "rmse"} lists.
    Runs on ``device`` (default: CUDA; pass "cpu" for the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to score on the CPU")
        device = "cuda"
    t = torch.as_tensor(np.asarray(target)[..., 0], device=device)
    p = torch.as_tensor(np.asarray(pred)[..., 0], device=device)
    ssim, psnr, mse = (a.cpu().numpy() for a in recon_metrics_device(t, p))
    return {"ssim": list(ssim.astype(float)), "psnr": list(psnr.astype(float)),
            "rmse": list(mse.astype(float))}


def compute_segmentation_metrics(target, pred) -> Dict[str, list]:
    """Per-class (1-3) Dice/IoU with +1 smoothing and a 0.5 threshold, on
    the host (src/util.py:946-953, 980-992).  target [B, H, W, 1] labels;
    pred [B, H, W, >=3], channel i for class i+1."""
    t = np.asarray(target)[..., 0]
    p = np.asarray(pred)
    dice_out, iou_out = [], []
    for b in range(t.shape[0]):
        dl, il = [], []
        for i in range(3):
            gt_i = t[b] == (i + 1)
            pr_i = p[b, ..., i] > 0.5
            inter = np.logical_and(gt_i, pr_i).sum()
            union = np.logical_or(gt_i, pr_i).sum()
            dl.append((2.0 * inter + 1) / (gt_i.sum() + pr_i.sum() + 1))
            il.append((inter + 1) / (union + 1))
        dice_out.append(float(np.mean(dl)))
        iou_out.append(float(np.mean(il)))
    return {"dice": dice_out, "iou": iou_out}
