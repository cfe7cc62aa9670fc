"""The legacy pickle dataset and its transforms (JAX ``data/
transforms.py``; reference src/util.py:32-146): the ZeroDose-GAN lineage's
data path, a pickled list of sample dicts and composable numpy transforms
on [H, W, C] arrays.  Randomness comes from a ``np.random.Generator``, so
the same generator gives the same arrays as the JAX package's.
``MedicalDataset`` is a ``torch.utils.data.Dataset`` of numpy samples
(``DataLoader``'s collate makes them tensors).  The active pipeline is
``data/dataset.py``.
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence

import numpy as np
from torch.utils.data import Dataset


class AddNoise:
    """Uniform noise within +-max_per of the max, clipped >= 0
    (src/util.py:73-82)."""

    def __init__(self, max_per: float = 0.1,
                 rng: Optional[np.random.Generator] = None):
        self.max_per = max_per
        self.rng = rng or np.random.default_rng()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        mv = self.max_per * np.max(x)
        noise = 2 * mv * self.rng.random(x.shape) - mv
        return np.clip(x + noise, 0, None)


class Dropoff:
    """Random input-subset selection (pet-only / mr-only / both,
    src/util.py:84-96); single-channel targets pass through."""

    def __init__(self, all_idx=(0, 1, 2, 3),
                 rnd_idx=((0,), (1, 2, 3), (0, 1, 2, 3)),
                 rng: Optional[np.random.Generator] = None):
        self.all_idx = list(all_idx)
        self.rnd_idx = [list(r) for r in rnd_idx]
        self.rng = rng or np.random.default_rng()

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if x.shape[2] != 1:
            keep = self.rnd_idx[self.rng.integers(len(self.rnd_idx))]
            x = x.copy()
            x[:, :, np.setdiff1d(self.all_idx, keep)] = 0
        return x


class Tile:
    """Tile the channel axis (src/util.py:99-106)."""

    def __init__(self, output_channel: int = 3):
        self.output_channel = output_channel

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.tile(x, [1, 1, self.output_channel])


class CenterCropAndPad:
    """Center crop / zero pad H x W to ``output_size``, which must be
    divisible by 32 (src/util.py:108-146)."""

    def __init__(self, output_size):
        assert isinstance(output_size, tuple)
        self.output_size = output_size

    def __call__(self, x: np.ndarray) -> np.ndarray:
        h, w = x.shape[:2]
        nh, nw = self.output_size
        if nh % 32 or nw % 32:
            raise ValueError("input size cannot divided by 32")
        if (nh, nw) == (h, w):
            return x
        up = (nh - h) // 2
        down = nh - h - up
        left = (nw - w) // 2
        right = nw - w - left
        if up >= 0 or down >= 0:
            x = np.pad(x, ((up, down), (0, 0), (0, 0)))
        else:
            x = x[-up:h + down]
        if left >= 0 or right >= 0:
            x = np.pad(x, ((0, 0), (left, right), (0, 0)))
        else:
            x = x[:, -left:w + right]
        return x


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class MedicalDataset(Dataset):
    """Pickled-sample dataset for the reconstruction / autoencoding /
    classification tasks (src/util.py:32-71): samples hold 'input' [H, W,
    C], 'target' [H, W, 1] and optionally 'label'."""

    def __init__(self, data_path: str, task: str = "reconstruction",
                 contrast_idx=(0, 1, 2), transform=None):
        with open(data_path, "rb") as f:
            self.samples: List[dict] = pickle.load(f)
        self.contrast_idx = list(contrast_idx)
        self.transform = transform or (lambda x: x)
        self.task = task

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        s = self.samples[idx]
        inp = s["input"][:, :, self.contrast_idx]
        if self.task == "reconstruction":
            return {"input": self.transform(inp).astype(np.float32),
                    "target": self.transform(s["target"]).astype(np.float32)}
        if self.task == "autoencoding":
            return {"input": self.transform(inp).astype(np.float32),
                    "target": inp.astype(np.float32)}
        return {"input": self.transform(s["target"]).astype(np.float32),
                "label": s.get("label", 0)}
