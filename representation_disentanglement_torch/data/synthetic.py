"""Synthetic datasets with the reference's data contract (a copy of the JAX
package's ``data/synthetic.py``): phantom brains, ellipsoid "anatomy"
shared across contrasts with per-contrast intensity transforms, z-scored
with background -10.

``synthetic_volumes`` makes the volumes in memory (a ``VolumeStore``'s
``data``); ``make_synthetic_dataset`` writes them as the HDF5 file and fold
txts: the same datasets and txts as the JAX package's from the same seed.
The txts go through ``preprocess.write_fold_txts`` (``one_fold`` and
``by_split`` shape a train / val / test split for it).
``h5py`` is imported only by ``make_synthetic_dataset``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from representation_disentanglement_torch.data.dataset import fold_txt_names
from representation_disentanglement_torch.data.preprocess import (
    split_rows, write_fold_txts)

_H5_NAME = {
    ("BraTS", "z-score"): "BraTS_All_zscore_10.h5",
    ("BraTS", "mean"): "BraTS_All.h5",
    ("ZeroDose", "z-score"): "ZeroDose_FDG_All_1103_zscore_10.h5",
    ("ZeroDose", "mean"): "ZeroDose_FDG_All_1103.h5",
    ("NCANDA", "z-score"): "NCANDA_All_zscore_10.h5",
    ("NCANDA", "mean"): "NCANDA_All.h5",
}
_SUBJ_PREFIX = {"BraTS": "BraTS20_Training_", "ZeroDose": "case_",
                "NCANDA": "NCANDA_S0"}


def phantom_volume(rng: np.random.Generator, shape=(160, 192, 155),
                   n_blobs: int = 4):
    """Shared 'anatomy': a few smooth ellipsoid blobs inside a brain mask.
    Returns (volume [H, W, D] f32, brain mask [H, W, D] bool)."""
    H, W, D = shape
    yy, xx, zz = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                             np.linspace(-1, 1, D), indexing="ij")
    brain = ((yy / 0.8) ** 2 + (xx / 0.7) ** 2 + (zz / 0.9) ** 2) < 1.0
    vol = np.zeros(shape, np.float32)
    for _ in range(n_blobs):
        c = rng.uniform(-0.5, 0.5, 3)
        r = rng.uniform(0.15, 0.45, 3)
        blob = np.exp(-(((yy - c[0]) / r[0]) ** 2 + ((xx - c[1]) / r[1]) ** 2
                        + ((zz - c[2]) / r[2]) ** 2))
        vol += rng.uniform(0.3, 1.0) * blob.astype(np.float32)
    return vol * brain, brain


def synthetic_volumes(dataset_name: str = "BraTS",
                      contrast_list: Sequence[str] = ("T1", "T2"),
                      norm_type: str = "z-score", n_subj: int = 6,
                      shape=(64, 96, 32), seed: int = 10,
                      missing_prob: float = 0.0
                      ) -> Tuple[Dict[str, np.ndarray], List[str],
                                 np.random.Generator]:
    """``<subj>/<contrast>`` (and the target) -> [H, W, D] f32 volumes of
    ``n_subj`` phantom subjects.  Returns (volumes, subjects, the generator
    after the draws)."""
    rng = np.random.default_rng(seed)
    subjects = [f"{_SUBJ_PREFIX[dataset_name]}{i:03d}" for i in range(n_subj)]
    vols: Dict[str, np.ndarray] = {}
    for subj in subjects:
        anatomy, brain = phantom_volume(rng, shape)
        for contrast in contrast_list:
            if missing_prob and rng.random() < missing_prob:
                continue                         # absent contrast
            gain = rng.uniform(0.5, 2.0)
            gamma = rng.uniform(0.7, 1.4)
            img = gain * np.power(np.clip(anatomy, 0, None) + 0.05, gamma)
            img += 0.02 * rng.standard_normal(shape).astype(np.float32)
            img = img * brain
            if norm_type == "z-score":
                mu, sd = img[brain].mean(), img[brain].std() + 1e-6
                img = (img - mu) / sd
                img[~brain] = -10.0              # background := -10
            vols[f"{subj}/{contrast}"] = img.astype(np.float32)
        if dataset_name == "BraTS":
            seg = (anatomy > np.quantile(anatomy[brain], 0.9)).astype(
                np.float32)
            vols[f"{subj}/seg"] = seg * rng.integers(1, 5, 1)[0]
        elif dataset_name == "ZeroDose":
            vols[f"{subj}/PET"] = np.clip(anatomy * 1.5, 0,
                                          None).astype(np.float32)
    return vols, subjects, rng


SPLITS = ("train", "val", "test")


def one_fold(splits: Sequence[Sequence[str]], slice_range=(8, 24)):
    """The subject lists ``splits`` (train, val, test) as one fold of
    ``preprocess.write_fold_txts``: a ``subj slice`` row per subject and
    slice of ``range(*slice_range)``."""
    return [{p: split_rows(s, slice_range) for p, s in zip(SPLITS, splits)}]


def by_split(names: Sequence[str]):
    """A ``write_fold_txts`` name function giving ``names`` (train, val,
    test)."""
    return lambda _fold, split: names[SPLITS.index(split)]


def make_synthetic_dataset(data_path: str, dataset_name: str = "BraTS",
                           contrast_list: Sequence[str] = ("T1", "T2"),
                           norm_type: str = "z-score", n_subj: int = 6,
                           shape=(64, 96, 32), fold: int = 0,
                           slice_range=(8, 24), seed: int = 10,
                           missing_prob: float = 0.0) -> str:
    """Write the h5 + fold txts contract into `data_path`; returns h5 path."""
    import h5py
    os.makedirs(data_path, exist_ok=True)
    vols, subjects, rng = synthetic_volumes(
        dataset_name, contrast_list, norm_type, n_subj, shape, seed,
        missing_prob)
    h5_path = os.path.join(data_path, _H5_NAME[(dataset_name, norm_type)])
    with h5py.File(h5_path, "w") as f:
        for key, vol in vols.items():
            f.create_dataset(key, data=vol)

    # fold txts: seed-shuffled subjects
    order = list(subjects)
    rng.shuffle(order)
    n_test = max(1, n_subj // 5)
    n_val = max(1, n_subj // 6)
    test_s = order[:n_test]
    val_s = order[n_test:n_test + n_val]
    train_s = order[n_test + n_val:] or order[:1]
    write_fold_txts(one_fold((train_s, val_s, test_s), slice_range),
                    data_path, by_split(fold_txt_names(
                        dataset_name, fold, len(contrast_list))))
    return h5_path
