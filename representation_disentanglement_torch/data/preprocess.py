"""Offline preprocessing: NIfTI volumes -> the HDF5 file and fold txts the
training run reads (JAX ``data/preprocess.py``; the reference's
data_preprocessing_{BraTS,NCANDA,ZeroDose}.py).

- BraTS (:80-96): (240, 240, 155); NaN -> 0; crop [40:-40, 24:-24] ->
  (160, 192, 155); z-score over the brain (img > 0), background -10; fold
  txts over slices 50-104, subjects shuffled with seed 10, 5 folds.
- NCANDA (:47-62): (240, 240, 240) cropped [40:-40, 24:-24, 40:-40] ->
  (160, 192, 160); the same z-score; slices 60-99.
- ZeroDose (:118-137): times the brain mask, clipped >= 0, z-scored over
  the mask, background -10, zero-padded (157, 189) -> (160, 192); slices
  20-135.

The numeric core is numpy.  ``nibabel`` is imported only to read a NIfTI
file (``_load_nii``) and ``h5py`` as the JAX module imports it; the dataset
functions raise ``ImportError`` without them.  ``write_fold_txts`` also writes the
txts of ``data/synthetic.py``'s phantom datasets.

Usage:
  python -m representation_disentanglement_torch.data.preprocess brats \\
      --input-dir .../MICCAI_BraTS2020_TrainingData --output-dir ../data
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import h5py
except ImportError:
    h5py = None


# ---------------------------------------------------------------------------
# numeric core
# ---------------------------------------------------------------------------

def zscore_brain(img: np.ndarray, brain: Optional[np.ndarray] = None,
                 background: float = -10.0) -> np.ndarray:
    """Z-score over the brain voxels (img > 0 unless ``brain`` is given);
    the rest set to ``background`` (data_preprocessing_BraTS.py:87-96)."""
    img = np.nan_to_num(img.astype(np.float32), nan=0.0)
    if brain is None:
        brain = img > 0
    brain = brain.astype(bool)
    if brain.sum() == 0:
        return np.full_like(img, background)
    mu = img[brain].mean()
    sd = img[brain].std() + 1e-8
    out = (img - mu) / sd
    out[~brain] = background
    return out


def crop_brats(vol: np.ndarray) -> np.ndarray:
    """(240, 240, 155) -> (160, 192, 155) (data_preprocessing_BraTS.py:85)."""
    return vol[40:-40, 24:-24]


def crop_ncanda(vol: np.ndarray) -> np.ndarray:
    """(240, 240, 240) -> (160, 192, 160) (data_preprocessing_NCANDA.py:52)."""
    return vol[40:-40, 24:-24, 40:-40]


def pad_zerodose(vol: np.ndarray) -> np.ndarray:
    """(157, 189, D) -> (160, 192, D), zeros after
    (data_preprocessing_ZeroDose.py:136-137)."""
    h, w = vol.shape[:2]
    return np.pad(vol, ((0, 160 - h), (0, 192 - w), (0, 0)))


def make_folds(subjects: Sequence[str], slice_range: Tuple[int, int],
               num_fold: int = 5, seed: int = 10,
               val_frac: float = 0.1, test_frac: float = 0.2
               ) -> List[Dict[str, List[Tuple[str, int]]]]:
    """Subjects shuffled with ``seed``; fold f tests the f-th block of
    max(n * test_frac, 1) subjects, validates on the first max(n *
    val_frac, 1) of the rest and trains on the others.  Each split lists
    its (subject, slice) rows over ``range(*slice_range)``
    (data_preprocessing_BraTS.py:100-146)."""
    subjects = list(subjects)
    np.random.RandomState(seed).shuffle(subjects)
    n = len(subjects)
    n_test = max(int(n * test_frac), 1)
    n_val = max(int(n * val_frac), 1)
    folds = []
    for f in range(num_fold):
        lo = (f * n_test) % max(n, 1)
        test_s = subjects[lo:lo + n_test]
        rest = [s for s in subjects if s not in test_s]
        folds.append({"train": split_rows(rest[n_val:], slice_range),
                      "val": split_rows(rest[:n_val], slice_range),
                      "test": split_rows(test_s, slice_range)})
    return folds


def split_rows(subjects: Sequence[str],
               slice_range: Tuple[int, int]) -> List[Tuple[str, int]]:
    """(subject, slice) for each subject and slice of the range."""
    return [(s, i) for s in subjects for i in range(*slice_range)]


def write_fold_txts(folds, out_dir: str, name_fn) -> None:
    """One ``subject slice`` line per row, in the file ``name_fn(fold,
    split)`` of ``out_dir`` for each split of each fold."""
    os.makedirs(out_dir, exist_ok=True)
    for f, split in enumerate(folds):
        for part, rows in split.items():
            with open(os.path.join(out_dir, name_fn(f, part)), "w") as fh:
                for subj, sl in rows:
                    fh.write(f"{subj} {sl}\n")


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _load_nii(path: str) -> np.ndarray:
    try:
        import nibabel as nib
    except ImportError as e:
        raise ImportError(
            "nibabel is required to read NIfTI inputs; install it or "
            "convert volumes to HDF5 with another tool") from e
    return np.asarray(nib.load(path).get_fdata(), np.float32)


_BRATS_CONTRASTS = {"T1": "t1", "T1c": "t1ce", "T2": "t2",
                    "T2_FLAIR": "flair", "seg": "seg"}


def _require_h5py() -> None:
    if h5py is None:
        raise ImportError("h5py required")


def preprocess_brats(input_dir: str, output_dir: str,
                     num_fold: int = 5) -> str:
    """BraTS 2020 -> BraTS_All_zscore_10.h5 + fold_BraTS_* txts.  A subject
    with a contrast missing or of another shape is skipped (a missing
    ``seg`` is allowed)."""
    _require_h5py()
    os.makedirs(output_dir, exist_ok=True)
    h5_path = os.path.join(output_dir, "BraTS_All_zscore_10.h5")
    subjects = []
    with h5py.File(h5_path, "w") as f:
        for sd in sorted(glob.glob(os.path.join(input_dir, "BraTS20_*"))):
            subj = os.path.basename(sd)
            ok, vols = True, {}
            for cname, suffix in _BRATS_CONTRASTS.items():
                p = os.path.join(sd, f"{subj}_{suffix}.nii.gz")
                if not os.path.exists(p):
                    p = p[:-3]                     # .nii fallback
                if not os.path.exists(p):
                    ok = cname == "seg"
                    continue
                vol = _load_nii(p)
                if vol.shape != (240, 240, 155):
                    print(f"skip {subj}: shape {vol.shape}")
                    ok = False
                    break
                vol = crop_brats(vol)
                vols[cname] = vol if cname == "seg" else zscore_brain(vol)
            if not ok or not vols:
                continue
            for cname, vol in vols.items():
                f.create_dataset(f"{subj}/{cname}", data=vol)
            subjects.append(subj)
    write_fold_txts(make_folds(subjects, (50, 105), num_fold), output_dir,
                    lambda f, p: f"fold_BraTS_{f}_{p}_noval.txt")
    return h5_path


def preprocess_ncanda(input_dir: str, output_dir: str,
                      num_fold: int = 5) -> str:
    """NCANDA T1/T2 -> NCANDA_All_zscore_10.h5 + fold_NCANDA_* txts, over
    the subjects with both contrasts."""
    _require_h5py()
    os.makedirs(output_dir, exist_ok=True)
    h5_path = os.path.join(output_dir, "NCANDA_All_zscore_10.h5")
    found = {c: {os.path.basename(p).split("_")[0]: p for p in
                 glob.glob(os.path.join(input_dir, f"*{c}*.nii*"))}
             for c in ("T1", "T2")}
    subjects = sorted(set(found["T1"]) & set(found["T2"]))
    with h5py.File(h5_path, "w") as f:
        for subj in subjects:
            for cname in ("T1", "T2"):
                vol = crop_ncanda(_load_nii(found[cname][subj]))
                f.create_dataset(f"{subj}/{cname}", data=zscore_brain(vol))
    write_fold_txts(make_folds(subjects, (60, 100), num_fold), output_dir,
                    lambda f, p: f"fold_NCANDA_{f}_{p}.txt")
    return h5_path


_ZD_FILES = {"T1": "tpm_T1.nii", "PET": "tpm_r2T1_PET.nii",
             "T1c": "tpm_r2T1_T1c.nii", "T2_FLAIR": "tpm_r2T1_T2_FLAIR.nii",
             "ASL": "tpm_r2PET_ASL.nii"}


def preprocess_zerodose(input_dir: str, output_dir: str, mask_path: str,
                        num_fold: int = 5,
                        contrasts: Sequence[str] = ("T1", "T1c", "T2_FLAIR",
                                                    "ASL")) -> str:
    """ZeroDose SPM-space volumes -> ZeroDose_FDG_All_1103_zscore_10.h5 +
    fold txts over the subjects with every contrast and the PET."""
    _require_h5py()
    os.makedirs(output_dir, exist_ok=True)
    h5_path = os.path.join(output_dir, "ZeroDose_FDG_All_1103_zscore_10.h5")
    brain = _load_nii(mask_path) > 0
    subj_dirs = sorted(d for d in glob.glob(os.path.join(input_dir, "*"))
                       if os.path.isdir(d))
    complete: List[str] = []
    with h5py.File(h5_path, "w") as f:
        for sd in subj_dirs:
            subj = os.path.basename(sd)
            vols = {}
            for cname, fname in _ZD_FILES.items():
                p = os.path.join(sd, fname)
                if not os.path.exists(p):
                    continue
                vol = _load_nii(p)
                mask = brain[..., :vol.shape[2]]
                vol = np.clip(vol * mask, 0, None)            # (:127)
                vols[cname] = pad_zerodose(zscore_brain(vol, mask))
            for cname, vol in vols.items():
                f.create_dataset(f"{subj}/{cname}", data=vol)
            if all(c in vols for c in contrasts) and "PET" in vols:
                complete.append(subj)
    sel = {2: "1103_sel", 3: "3contrasts_sel", 4: "4contrasts_sel_all"}
    write_fold_txts(make_folds(complete, (20, 136), num_fold), output_dir,
                    lambda f, p: f"fold{f}_{p}_{sel[len(contrasts)]}.txt")
    return h5_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="dataset", required=True)
    for name in ("brats", "ncanda", "zerodose"):
        sp = sub.add_parser(name)
        sp.add_argument("--input-dir", required=True)
        sp.add_argument("--output-dir", required=True)
        sp.add_argument("--num-fold", type=int, default=5)
        if name == "zerodose":
            sp.add_argument("--mask", required=True)
    args = ap.parse_args(argv)
    if args.dataset == "brats":
        print(preprocess_brats(args.input_dir, args.output_dir,
                               args.num_fold))
    elif args.dataset == "ncanda":
        print(preprocess_ncanda(args.input_dir, args.output_dir,
                                args.num_fold))
    else:
        print(preprocess_zerodose(args.input_dir, args.output_dir,
                                  args.mask, args.num_fold))


if __name__ == "__main__":
    main()
