"""Whole-volume 3D datasets (a copy of the JAX package's
``data/dataset3d.py``; reference src/util.py:723-843).

``VolumeDataset3D`` emits per-subject volume slabs for the NVNet3D path:
BraTS uses the depth slab [45:-46] of the 155-slice volume (64 slices),
ZeroDose [45:-47]; BraTS label 4 becomes 3; with ``dropoff`` one present
contrast is zeroed with probability 0.2; augmentation is an H-flip plus a
random intensity scale/shift with the background re-pinned to -10
(src/util.py:798-805).  A sample that fails to load is None (the
reference's SafeDataset drops it).

Output is in the port's layout: inputs [M, H, W, D] per sample, targets
[1, H, W, D]; ``collate_volumes`` stacks them to [B, M, H, W, D] and
[B, 1, H, W, D].  From the same store and seed the arrays equal the JAX
package's ([M, D, H, W], [D, H, W, 1]; batches [B, D, H, W, M]) up to that
transpose: the random draws are the same, in the same order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from representation_disentanglement_torch.data.dataset import (
    VolumeStore, _TARGET_KEY)


class VolumeDataset3D:
    def __init__(self, dataset_name: str, store: VolumeStore,
                 subj_list: Sequence[str],
                 contrast_list: Sequence[str] = ("T1",), aug: bool = False,
                 dropoff: bool = False, image_size=(160, 192, 64),
                 slab: Optional[slice] = None,
                 rng: Optional[np.random.Generator] = None):
        self.dataset_name = dataset_name
        self.store = store
        self.subj_list = list(subj_list)
        self.contrast_list = list(contrast_list)
        self.aug = aug
        self.dropoff = dropoff
        self.image_size = list(image_size)      # (H, W, D)
        if slab is None:
            slab = slice(45, -47) if dataset_name == "ZeroDose" \
                else slice(45, -46)             # src/util.py:766-769
        self.slab = slab
        self.rng = rng or np.random.default_rng(10)

    def __len__(self):
        return len(self.subj_list)

    def __getitem__(self, idx: int) -> Optional[dict]:
        try:
            subj = str(self.subj_list[idx])
            H, W, D = self.image_size
            imgs, mask = [], []
            for contrast in self.contrast_list:
                key = f"{subj}/{contrast}"
                if key in self.store:
                    imgs.append(self.store.get(key)[:, :, self.slab])
                    mask.append(1)
                else:
                    imgs.append(np.zeros((H, W, D), np.float32))
                    mask.append(0)
            mask = np.array(mask, np.float32)
            inputs = np.stack(imgs, 0)                    # [M, H, W, D]

            tkey = _TARGET_KEY.get(self.dataset_name)
            if tkey and f"{subj}/{tkey}" in self.store:
                targets = self.store.get(f"{subj}/{tkey}")[
                    :, :, self.slab].copy()
                if self.dataset_name == "BraTS":
                    targets[targets == 4] = 3.0
            else:
                targets = np.zeros((H, W, D), np.float32)

            if self.dropoff and mask.sum() > 1:
                if self.rng.random() > 0.8:
                    drop = self.rng.choice(np.where(mask == 1)[0])
                    inputs[drop] = 0.0
                    mask[drop] = 0.0

            if self.aug:
                if self.rng.random() > 0.5:               # H flip
                    inputs = inputs[:, ::-1].copy()
                    targets = targets[::-1].copy()
                scale = 1 + 0.2 * (self.rng.random() - 0.5)
                shift = 0.2 * (self.rng.random() - 0.5)
                inputs = inputs * scale + shift
                inputs[inputs == inputs.min()] = -10.0    # src/util.py:805

            return {"inputs": inputs.astype(np.float32),
                    "targets": targets[None].astype(np.float32),
                    "subj_id": subj, "mask": mask, "slice_idx": 0,
                    # the JAX package's inputs[0, :, :, 0] of [M, D, H, W]
                    # ([D, H]), here [H, D]
                    "mask_img": (inputs[0, :, 0, :] == 0).astype(
                        np.float32)}
        except Exception:
            return None


def collate_volumes(samples):
    """[M, H, W, D] samples -> a batch dict with inputs [B, M, H, W, D]
    (contrasts as channels, the NVNet3D input) and targets [B, 1, H, W,
    D]."""
    return {
        "inputs": np.stack([s["inputs"] for s in samples], 0),
        "targets": np.stack([s["targets"] for s in samples], 0),
        "mask": np.stack([s["mask"] for s in samples], 0),
        "subj_id": [s["subj_id"] for s in samples],
    }
