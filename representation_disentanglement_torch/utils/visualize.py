"""Result pictures and volume export (JAX ``utils/visualize.py``;
reference src/util.py:173-309), numpy in and out.

- ``save_test_result``: per-sample JPEG panels input | target | prediction
  | error, and jet-coloured attention-map overlays (src/util.py:173-255);
- ``save_test_result_by_volume``: per-slice outputs put back into subject
  volumes of ``slice_per_subj`` slices (quirk Q5: the reference fixes 115,
  src/util.py:257), per-volume metrics (the port's ``metrics.py`` on
  ``device``, CUDA unless asked), optional NIfTI export;
- ``save_volume_nifti``: the NIfTI writer of these and of the serve CLI.

The jet colour map and RGB <-> HSV are numpy (the reference used
scipy.misc, skimage and matplotlib).  PIL is imported only to write a JPEG
and ``nibabel`` only to write a NIfTI file; without them those calls raise
``ImportError``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from representation_disentanglement_torch.metrics import (
    compute_reconstruction_metrics)


# ---------------------------------------------------------------------------
# colour kit
# ---------------------------------------------------------------------------

def jet_colormap(x: np.ndarray) -> np.ndarray:
    """Matplotlib-'jet'-style colour map of [0, 1] -> RGB [..., 3]."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return np.stack([r, g, b], axis=-1)


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, axis=-1)
    minc = np.min(rgb, axis=-1)
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        rc = (maxc - r) / np.maximum(delta, 1e-12)
        gc = (maxc - g) / np.maximum(delta, 1e-12)
        bc = (maxc - b) / np.maximum(delta, 1e-12)
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, (h / 6.0) % 1.0)
    return np.stack([h, s, maxc], axis=-1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    out = np.zeros(hsv.shape)
    for k, c in enumerate([(v, t, p), (q, v, p), (p, v, t), (p, q, v),
                           (t, p, v), (v, p, q)]):
        out = np.where((i == k)[..., None], np.stack(c, -1), out)
    return out


def _save_jpg(path: str, img: np.ndarray) -> None:
    from PIL import Image
    arr = np.clip(img, 0, 1) if img.dtype.kind == "f" else img
    if arr.dtype.kind == "f":
        arr = (arr * 255).astype(np.uint8)
    Image.fromarray(arr).save(path, quality=92)


def _resize_nearest(img: np.ndarray, out_hw) -> np.ndarray:
    h, w = img.shape[:2]
    yi = (np.arange(out_hw[0]) * h // out_hw[0]).clip(0, h - 1)
    xi = (np.arange(out_hw[1]) * w // out_hw[1]).clip(0, w - 1)
    return img[yi][:, xi]


# ---------------------------------------------------------------------------
# panels and overlays (src/util.py:173-255)
# ---------------------------------------------------------------------------

def save_test_result(res: Dict[str, np.ndarray], test_dir: str, bs: int,
                     iteration: int, save_att_maps: bool = False,
                     task: str = "reconstruction") -> None:
    """res: {'real_A': [B, C, H, W], 'real_B' / 'fake_B': [B, 1, H, W],
    'alpha_*': [B, 1, h, w]} (NCHW, as the reference's).  Writes
    ``{bs * iteration + i:03d}.jpg`` per sample, each panel rotated 90
    degrees and scaled by its maximum (a segmentation prediction is
    thresholded at 0.5), and ``_att_maps.jpg`` overlays with
    ``save_att_maps``."""
    os.makedirs(test_dir, exist_ok=True)
    alpha_keys = sorted(k for k in res if k.startswith("alpha"))
    for i in range(min(res["fake_B"].shape[0], bs)):
        idx = bs * iteration + i
        real_a = np.rot90(res["real_A"][i], axes=(1, 2))
        panels: List[np.ndarray] = []
        for a in real_a:
            m = np.max(a)
            panels.append(a / m if m > 0 else a)
        real_b = np.rot90(res["real_B"][i][0], axes=(0, 1))
        fake_b = np.rot90(res["fake_B"][i][0], axes=(0, 1))
        if task == "reconstruction":
            for arr in (real_b, fake_b):
                m = np.max(arr)
                if m > 0:
                    arr /= m
        else:
            fake_b = (fake_b >= 0.5).astype(np.float32)
        panels += [real_b, fake_b, np.abs(real_b - fake_b)]
        _save_jpg(os.path.join(test_dir, f"{idx:03d}.jpg"),
                  np.concatenate(panels, axis=1))

        if save_att_maps and alpha_keys:
            att = np.concatenate(
                [_resize_nearest(np.rot90(res[k][i][0], axes=(0, 1)),
                                 real_b.shape) for k in alpha_keys], axis=1)
            att = np.concatenate([att, att], axis=0)
            bg = np.tile(real_b, (1, len(alpha_keys)))
            bg = np.concatenate([bg, np.ones_like(bg)], axis=0)
            bg_hsv = rgb_to_hsv(np.dstack([bg, bg, bg]))
            att_hsv = rgb_to_hsv(jet_colormap(att))
            bg_hsv[..., 0] = att_hsv[..., 0]
            bg_hsv[..., 1] = att_hsv[..., 1] * 0.5
            _save_jpg(os.path.join(test_dir, f"{idx:03d}_att_maps.jpg"),
                      hsv_to_rgb(bg_hsv))


# ---------------------------------------------------------------------------
# volumes and NIfTI export (src/util.py:257-309)
# ---------------------------------------------------------------------------

def require_nibabel():
    try:
        import nibabel
    except ImportError as e:
        raise ImportError("nibabel required for NIfTI export") from e
    return nibabel


def save_volume_nifti(save_path: str, data: np.ndarray) -> None:
    """data: [D, H, W] (slice-major) -> NIfTI [H, W, D], identity affine."""
    nib = require_nibabel()
    nib.save(nib.Nifti1Image(np.transpose(data, (1, 2, 0)), np.eye(4)),
             save_path)


def save_test_result_by_volume(real_b: np.ndarray, fake_b: np.ndarray,
                               test_dir: str, save_nifti: bool = False,
                               slice_per_subj: int = 115,
                               device=None) -> Dict[str, list]:
    """Stacked per-slice outputs [N, H, W] -> subject volumes of
    ``slice_per_subj`` slices (quirk Q5 default), each scaled by its
    maximum: the mean PSNR, SSIM and MSE ('rmse') per volume, and with
    ``save_nifti`` ``subj_{i}_real.nii`` / ``_fake.nii``."""
    os.makedirs(test_dir, exist_ok=True)
    subj_num = real_b.shape[0] // slice_per_subj
    if subj_num * slice_per_subj != real_b.shape[0]:
        print("Might missing some slices!")
    out: Dict[str, list] = {"psnr": [], "ssim": [], "rmse": []}
    for i in range(subj_num):
        sl = slice(slice_per_subj * i, slice_per_subj * (i + 1))
        rb, fb = real_b[sl], fake_b[sl]
        if save_nifti:
            save_volume_nifti(os.path.join(test_dir, f"subj_{i}_real.nii"),
                              rb)
            save_volume_nifti(os.path.join(test_dir, f"subj_{i}_fake.nii"),
                              fb)
        m = compute_reconstruction_metrics(
            (rb / max(rb.max(), 1e-12))[..., None],
            (fb / max(fb.max(), 1e-12))[..., None], device=device)
        for k in out:
            out[k].append(float(np.mean(m[k])))
    return out
