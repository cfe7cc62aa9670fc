"""HDF5 slice-block datasets with the reference's contract (a copy of the
JAX package's ``data/dataset.py``; reference src/util.py:445-720).

- HDF5 groups ``<subj_id>/<contrast>`` hold [H, W, D] normalized volumes;
- fold txts have rows ``subj_id slice_idx``;
- per sample: a 7-slice block [slice-3, slice+3] per contrast, zeros and
  mask 0 for an absent contrast; the slice index clamped to
  [block, 155-block] (89 for Tau); BraTS targets remap label 4 to 3;
  train-time dropoff of one present modality with probability 0.2;
  optional skull-strip; ``mask_img = (inputs[modality 0, channel 0] == 0)``
  (quirk Q6).

Batches are modality-major NHWC numpy arrays: inputs [M, B, H, W, Cb].
``SliceDataset.get_batch`` gathers a whole batch with one call of the C++
gather (``native.gather_blocks``) where ``native.available()``, else with
numpy; both give the same batches, and ``gather_branch`` names the one the
last batch took.
``h5py`` is imported only when an HDF5 file is opened; ``VolumeStore``
also takes volumes from memory, and ``DataAll`` and
``TestDropoffDataset`` take such a store in place of
``<data_path>/<h5 name>``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from representation_disentanglement_torch import native


def load_idx_list(file_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a fold txt of ``subj_id slice_idx`` rows (src/util.py:718-720)."""
    subjs, idxs = [], []
    with open(file_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            subjs.append(parts[0])
            idxs.append(int(parts[1]))
    return np.array(subjs), np.array(idxs, dtype=np.int64)


_H5_NAMES = {
    # dataset_name -> (mean-norm file, z-score file)   (src/util.py:637-697)
    "ZeroDose": ("ZeroDose_FDG_All_1103.h5", "ZeroDose_FDG_All_1103_zscore_10.h5"),
    "BraTS": ("BraTS_All.h5", "BraTS_All_zscore_10.h5"),
    "NCANDA": ("NCANDA_All.h5", "NCANDA_All_zscore_10.h5"),
    "Tau": (None, "Tau_All_zscore.h5"),
}

_TARGET_KEY = {"ZeroDose": "PET", "BraTS": "seg", "Tau": "pet_nifti/fulldose"}


def fold_txt_names(dataset_name: str, fold: int, n_contrasts: int):
    """The train, val and test fold txt names of a dataset (src/util.py:
    637-697); ZeroDose's depend on the contrast count (:650-668)."""
    splits = ("train", "val", "test")
    if dataset_name == "BraTS":
        return [f"fold_BraTS_{fold}_{s}_noval.txt" for s in splits]
    if dataset_name == "ZeroDose":
        sel = {2: "1103_sel", 3: "3contrasts_sel", 4: "4contrasts_sel_all"}
        if n_contrasts not in sel:
            raise ValueError("More than 4 input contrasts")
        return [f"fold{fold}_{s}_{sel[n_contrasts]}.txt" for s in splits]
    return [f"fold_{dataset_name}_{fold}_{s}.txt" for s in splits]


class VolumeStore:
    """``subj/contrast -> [H, W, D] float32`` volumes, from an HDF5 file
    (read whole into memory, as the JAX package's default does) and/or the
    dict ``data``."""

    def __init__(self, h5_path: Optional[str] = None,
                 data: Optional[Dict[str, np.ndarray]] = None):
        self._mem: Dict[str, np.ndarray] = dict(data or {})
        if h5_path is not None:
            import h5py

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    self._mem[name] = np.asarray(obj, dtype=np.float32)
            with h5py.File(h5_path, "r") as f:
                f.visititems(visit)

    def __contains__(self, key: str) -> bool:
        return key in self._mem

    def keys(self) -> List[str]:
        return list(self._mem)

    def get(self, key: str) -> np.ndarray:
        return self._mem[key]


class SliceDataset:
    """Reference ``ZeroDoseDataset`` parity (src/util.py:445-568): the
    per-sample ``__getitem__`` (None for a sample that fails to load, as
    the reference's SafeDataset drops it) and the batch gather
    ``get_batch``.  The reference's 2D ``aug`` branch is unusable upstream
    (a pdb trap before the flip), so ``aug`` is accepted and inert."""

    def __init__(self, dataset_name: str, store: VolumeStore,
                 subj_list: np.ndarray, idx_list: np.ndarray,
                 brain_mask: Optional[np.ndarray] = None, block_size: int = 3,
                 contrast_list: Sequence[str] = ("T1",), aug: bool = False,
                 dropoff: bool = False, skull_strip: bool = False,
                 image_size=(160, 192),
                 rng: Optional[np.random.Generator] = None):
        self.dataset_name = dataset_name
        self.store = store
        self.subj_list = subj_list
        self.idx_list = idx_list
        self.brain_mask = brain_mask
        self.block_size = block_size
        self.contrast_list = list(contrast_list)
        self.aug = aug
        self.dropoff = dropoff
        self.skull_strip = skull_strip
        self.image_size = list(image_size)
        self.rng = rng or np.random.default_rng(10)
        self._packed: Optional[dict] = None
        self.gather_branch: Optional[str] = None    # "native" | "numpy"

    def _pack(self):
        """Depth-major [D, H, W] C-contiguous f32 copies of every (subj,
        contrast) volume and target, made once and kept alive, so that a
        7-slice block is one contiguous copy (and one pointer for the
        native gather)."""
        packed = {"vols": {}, "tgts": {}}
        tkey = _TARGET_KEY.get(self.dataset_name)
        for subj in np.unique(self.subj_list):
            subj = str(subj)
            for contrast in self.contrast_list:
                key = f"{subj}/{contrast}"
                if key in self.store:
                    packed["vols"][(subj, contrast)] = np.ascontiguousarray(
                        np.transpose(self.store.get(key), (2, 0, 1)),
                        dtype=np.float32)
            if tkey is not None and f"{subj}/{tkey}" in self.store:
                t = np.ascontiguousarray(np.transpose(
                    self.store.get(f"{subj}/{tkey}"), (2, 0, 1)))
                if self.dataset_name == "BraTS":
                    t = t.copy()
                    t[t == 4] = 3.0
                packed["tgts"][subj] = t
        H, W = self.image_size
        packed["native_ok"] = native.available() and all(
            v.shape[1:] == (H, W) for v in packed["vols"].values())
        self._packed = packed

    def get_batch(self, indices: Sequence[int]) -> dict:
        """Collated batch: inputs [M, B, H, W, bc], targets [B, H, W, 1],
        mask [B, M], mask_img [B, H, W], subj_id, slice_idx.  The native
        branch resolves one block pointer per (modality, sample) task, 0
        for an absent modality, and packs the [M*B] tasks in one call."""
        if self._packed is None:
            self._pack()
        b = self.block_size
        bc = 2 * b + 1
        H, W = self.image_size
        Bn = len(indices)
        Mn = len(self.contrast_list)
        use_native = bool(self._packed["native_ok"])
        if use_native:
            inputs = np.empty((Mn, Bn, H, W, bc), np.float32)
            ptrs = np.zeros(Mn * Bn, np.uint64)
        else:
            inputs = np.zeros((Mn, Bn, H, W, bc), np.float32)
        targets = np.zeros((Bn, H, W, 1), np.float32)
        mask = np.zeros((Bn, Mn), np.float32)
        subj_ids, slice_idxs = [], []
        for j, idx in enumerate(indices):
            subj = str(self.subj_list[idx])
            sl = self._clamp_slice(int(self.idx_list[idx]))
            subj_ids.append(subj)
            slice_idxs.append(sl)
            for mi, contrast in enumerate(self.contrast_list):
                vol = self._packed["vols"].get((subj, contrast))
                if vol is None:
                    continue
                mask[j, mi] = 1.0
                if use_native:
                    if sl - b < 0 or sl + b + 1 > vol.shape[0]:
                        raise ValueError(
                            f"slice block [{sl - b}, {sl + b}] outside "
                            f"volume depth {vol.shape[0]} for {subj}")
                    ptrs[mi * Bn + j] = (vol.ctypes.data
                                         + (sl - b) * H * W * 4)
                else:
                    # contiguous depth block -> [bc, H, W] -> [H, W, bc]
                    inputs[mi, j] = np.transpose(vol[sl - b:sl + b + 1],
                                                 (1, 2, 0))
            tgt = self._packed["tgts"].get(subj)
            if tgt is not None:
                targets[j, :, :, 0] = tgt[sl]
        if use_native:
            native.gather_blocks(ptrs, inputs.reshape(Mn * Bn, H, W, bc))
        self.gather_branch = "native" if use_native else "numpy"
        if self.dropoff:
            for j in range(Bn):
                if mask[j].sum() > 1 and self.rng.random() > 0.8:
                    drop = self.rng.choice(np.where(mask[j] == 1)[0])
                    inputs[drop, j] = 0.0
                    mask[j, drop] = 0.0
        if self.skull_strip and self.brain_mask is not None:
            for j, sl in enumerate(slice_idxs):
                bm = self.brain_mask[:, :, sl - b:sl + b + 1]
                inputs[:, j] *= bm[None]
                targets[j, :, :, 0] *= self.brain_mask[:, :, sl]
        mask_img = (inputs[0, :, :, :, 0] == 0).astype(np.float32)
        return {"inputs": inputs, "targets": targets, "mask": mask,
                "mask_img": mask_img, "subj_id": subj_ids,
                "slice_idx": np.array(slice_idxs)}

    def __len__(self):
        return len(self.subj_list)

    def _clamp_slice(self, slice_idx: int) -> int:
        b = self.block_size
        hi = (89 if self.dataset_name == "Tau" else 155) - b
        return min(max(slice_idx, b), hi)

    def __getitem__(self, idx: int) -> Optional[dict]:
        try:
            subj_id = str(self.subj_list[idx])
            slice_idx = self._clamp_slice(int(self.idx_list[idx]))
            b = self.block_size
            bc = 2 * b + 1
            H, W = self.image_size
            imgs, mask = [], []
            for contrast in self.contrast_list:
                key = f"{subj_id}/{contrast}"
                if key in self.store:
                    vol = self.store.get(key)
                    imgs.append(vol[:, :, slice_idx - b:slice_idx + b + 1])
                    mask.append(1)
                else:
                    imgs.append(np.zeros((H, W, bc), np.float32))
                    mask.append(0)
            mask = np.array(mask, np.float32)
            inputs = np.stack(imgs, 0)                      # [M, H, W, bc]

            tkey = _TARGET_KEY.get(self.dataset_name)
            if tkey is not None and f"{subj_id}/{tkey}" in self.store:
                targets = self.store.get(f"{subj_id}/{tkey}")[
                    :, :, slice_idx:slice_idx + 1].copy()
                if self.dataset_name == "BraTS":
                    targets[targets == 4] = 3.0             # src/util.py:527
            else:
                targets = np.zeros((H, W, 1), np.float32)

            if self.dropoff and mask.sum() > 1:             # src/util.py:538
                if self.rng.random() > 0.8:
                    present = np.where(mask == 1)[0]
                    drop = self.rng.choice(present)
                    inputs[drop] = 0.0
                    mask[drop] = 0.0

            if self.skull_strip and self.brain_mask is not None:
                bm_in = self.brain_mask[:, :, slice_idx - b:slice_idx + b + 1]
                inputs = inputs * bm_in[None]
                targets = targets * self.brain_mask[:, :,
                                                    slice_idx:slice_idx + 1]

            # quirk Q6: background map from channel 0 of modality 0 only
            mask_img = (inputs[0, :, :, 0] == 0).astype(np.float32)
            return {"inputs": inputs.astype(np.float32), "targets":
                    targets.astype(np.float32), "subj_id": subj_id,
                    "slice_idx": slice_idx, "mask": mask,
                    "mask_img": mask_img}
        except Exception:
            # defensive loading parity (src/util.py:567-568 + SafeDataset)
            return None


class TestDropoffDataset:
    """The exhaustive drop harness of ``set: test_dropoff`` (src/util.py:
    571-632; JAX data/dataset.py:289-321): for each selected test row, every
    subset of at most two dropped contrasts, 1 + M + M(M-1)/2 drop types
    (11 at M=4), in the order [], [0], [0, 1], ..., [1], [1, 2], ...  A drop
    zeroes the contrast's inputs and mask column; ``mask_img`` is then
    recomputed from contrast 0."""

    def __init__(self, store: VolumeStore, subj_list, idx_list,
                 sel_idx_list: Sequence[int], block_size: int = 3,
                 contrast_list: Sequence[str] = ("T1",),
                 dataset_name: str = "ZeroDose", image_size=(160, 192)):
        self.base = SliceDataset(dataset_name, store, subj_list, idx_list,
                                 block_size=block_size,
                                 contrast_list=contrast_list,
                                 image_size=image_size)
        self.sel_idx_list = list(sel_idx_list)
        M = len(contrast_list)
        self.drop_type: List[List[int]] = [[]]
        for i in range(M):
            self.drop_type.append([i])
            for j in range(i + 1, M):
                self.drop_type.append([i, j])

    def __len__(self):
        return len(self.sel_idx_list) * len(self.drop_type)

    def __getitem__(self, idx: int) -> Optional[dict]:
        raw = idx // len(self.drop_type)
        drops = self.drop_type[idx % len(self.drop_type)]
        sample = self.base[self.sel_idx_list[raw]]
        if sample is None:
            return None
        for d in drops:
            sample["inputs"][d] = 0.0
            sample["mask"][d] = 0.0
        sample["mask_img"] = (
            sample["inputs"][0, :, :, 0] == 0).astype(np.float32)
        return sample


class DataAll:
    """Reference ``ZeroDoseDataAll`` parity (src/util.py:635-720): the
    train/val/test datasets of one fold.  The fold txts are read from
    ``data_path``; the volumes from ``store`` when given, else from
    ``<data_path>/<h5 name>``.  The reference's ``batch_size``,
    ``num_fold`` and ``shuffle`` are the loaders' business and not taken
    here."""

    def __init__(self, dataset_name: str, data_path: str,
                 norm_type: str = "mean", fold: int = 0,
                 block_size: int = 3, contrast_list: Sequence[str] = ("T1",),
                 aug: bool = False, dropoff: bool = False,
                 skull_strip: bool = False, image_size=(160, 192),
                 seed: int = 10, store: Optional[VolumeStore] = None):
        if store is None:
            names = _H5_NAMES[dataset_name]
            h5_name = names[0] if norm_type == "mean" else names[1]
            if h5_name is None:
                raise ValueError("Need preprocessed data for this norm_type")
            store = VolumeStore(os.path.join(data_path, h5_name))

        splits = [load_idx_list(os.path.join(data_path, f)) for f in
                  fold_txt_names(dataset_name, fold, len(contrast_list))]

        brain_mask = None
        mask_path = os.path.join(data_path, "tpm_mask.npy")
        if os.path.exists(mask_path):
            brain_mask = np.load(mask_path)

        rng = np.random.default_rng(seed)
        mk = lambda split, use_aug, use_drop: SliceDataset(
            dataset_name, store, split[0], split[1], brain_mask,
            block_size=block_size, contrast_list=contrast_list, aug=use_aug,
            dropoff=use_drop, skull_strip=skull_strip, image_size=image_size,
            rng=rng)
        self.train_dataset = mk(splits[0], aug, dropoff)
        self.val_dataset = mk(splits[1], False, dropoff)
        self.test_dataset = mk(splits[2], False, False)
        self.store = store
