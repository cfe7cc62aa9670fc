"""Device-resident volume cache and on-device slice-block gather (the
single-device part of the JAX package's ``data/device_store.py``).

Every volume of a split is uploaded once into device memory as a packed
``[S, M, D, H, W]`` tensor (bf16 by default, so training sees bf16-rounded
volumes, as in the JAX package), with the targets ``[S, D, H, W]`` in f32
and the contrast presence ``[S, M]``.  A batch then costs a few int64
indices over the host link instead of ~27 MB of slice blocks, and the
gather reads only the B*M*7 planes it needs.

``build_device_cache`` returns None when the packed volumes would exceed
``budget_bytes``; the caller then takes the host loader.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from representation_disentanglement_torch.data.dataset import (
    VolumeStore, _TARGET_KEY)


class DeviceVolumeCache:
    """vols: [S, M, D, H, W] device tensor; tgts: [S, D, H, W] f32;
    presence: [S, M] f32 (also kept on the host as ``presence_np``);
    subject order matches ``subjects``."""

    def __init__(self, vols: torch.Tensor, tgts: torch.Tensor,
                 presence: torch.Tensor, subjects: List[str],
                 block_size: int, clamp_hi: int):
        self.vols = vols
        self.tgts = tgts
        self.presence = presence
        self.presence_np = presence.cpu().numpy()
        self.subjects = subjects
        self.row: Dict[str, int] = {s: i for i, s in enumerate(subjects)}
        self.block_size = block_size
        self.clamp_hi = clamp_hi

    @property
    def nbytes(self) -> int:
        return self.vols.numel() * self.vols.element_size()


def _pack_host(dataset_name: str, store: VolumeStore,
               subj_list: Sequence[str], contrast_list: Sequence[str]):
    """Host-side packing: (vols [S, M, D, H, W] f32, tgts [S, D, H, W],
    presence [S, M], subjects), or None when no volume is present."""
    subjects = [str(s) for s in dict.fromkeys(np.asarray(subj_list).tolist())]
    if not subjects:
        return None
    probe = None
    for s in subjects:
        for c in contrast_list:
            if f"{s}/{c}" in store:
                probe = store.get(f"{s}/{c}")
                break
        if probe is not None:
            break
    if probe is None:
        return None
    H, W, D = probe.shape
    S, M = len(subjects), len(contrast_list)
    vols = np.zeros((S, M, D, H, W), np.float32)
    presence = np.zeros((S, M), np.float32)
    tgts = np.zeros((S, D, H, W), np.float32)
    tkey = _TARGET_KEY.get(dataset_name)
    for si, subj in enumerate(subjects):
        for mi, c in enumerate(contrast_list):
            key = f"{subj}/{c}"
            if key in store:
                vols[si, mi] = np.transpose(store.get(key), (2, 0, 1))
                presence[si, mi] = 1.0
        if tkey is not None and f"{subj}/{tkey}" in store:
            t = np.transpose(store.get(f"{subj}/{tkey}"), (2, 0, 1))
            if dataset_name == "BraTS":
                t = t.copy()
                t[t == 4] = 3.0
            tgts[si] = t
    return vols, tgts, presence, subjects


def build_device_cache(dataset_name: str, store: VolumeStore,
                       subj_list: Sequence[str],
                       contrast_list: Sequence[str], block_size: int = 3,
                       dtype: torch.dtype = torch.bfloat16,
                       budget_bytes: int = 12 * 2**30,
                       clamp_max: int = 155, device="cuda"
                       ) -> Optional[DeviceVolumeCache]:
    packed = _pack_host(dataset_name, store, subj_list, contrast_list)
    if packed is None:
        return None
    vols, tgts, presence, subjects = packed
    itemsize = torch.empty((), dtype=dtype).element_size()
    if vols.size * itemsize > budget_bytes:
        return None
    D = vols.shape[2]
    return DeviceVolumeCache(
        torch.from_numpy(vols).to(device=device, dtype=dtype),
        torch.from_numpy(tgts).to(device),
        torch.from_numpy(presence).to(device), subjects, block_size,
        min(clamp_max, D))


def gather_blocks(vols: torch.Tensor, tgts: torch.Tensor,
                  presence: torch.Tensor, rows: torch.Tensor,
                  slices: torch.Tensor, drop_mask: torch.Tensor,
                  block_size: int = 3) -> Dict[str, torch.Tensor]:
    """On-device batch assembly from the cache's tensors.

    rows, slices: int64 [B] on the cache's device; drop_mask: [B, M]
    multiplier (the host's dropoff draw; all ones when off).  Returns
    inputs [M, B, H, W, bc] (f32), targets [B, H, W, 1], mask [B, M],
    mask_img [B, H, W].  One advanced index reads the B*M*bc planes of the
    blocks, never whole volumes; it puts the indexed dims first
    ([B, bc, M, H, W]), which the permute turns into the batch layout."""
    offs = torch.arange(-block_size, block_size + 1, device=vols.device)
    v = vols[rows[:, None], :, slices[:, None] + offs]       # [B, bc, M, H, W]
    mask = presence[rows] * drop_mask                        # [B, M]
    inputs = v.permute(2, 0, 3, 4, 1).float()                # [M, B, H, W, bc]
    inputs = inputs * mask.t()[:, :, None, None, None]
    targets = tgts[rows, slices][..., None]
    mask_img = (inputs[0, :, :, :, 0] == 0).float()
    return {"inputs": inputs, "targets": targets, "mask": mask,
            "mask_img": mask_img}


class DeviceBatchLoader:
    """Batch iterator over a DeviceVolumeCache: the host shuffles indices
    and draws the dropoff; the tensors are assembled on the device."""

    def __init__(self, cache: DeviceVolumeCache, subj_list, idx_list,
                 batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, dropoff: bool = False,
                 seed: int = 10):
        self.cache = cache
        self.rows = np.array([cache.row[str(s)] for s in subj_list],
                             np.int64)
        b = cache.block_size
        D = cache.vols.shape[2]
        # reference clamp (util.py:477-484) and a hard bound so that a
        # block never reads past the volume (sl + b + 1 <= D)
        hi = min(cache.clamp_hi - b, D - b - 1)
        self.slices = np.clip(np.asarray(idx_list, np.int64), b, hi)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.dropoff = dropoff
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.rows)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.rows))
        if self.shuffle:
            self.rng.shuffle(order)
        n = len(order)
        stop = n // self.batch_size * self.batch_size if self.drop_last \
            else n
        presence_np = self.cache.presence_np
        M = presence_np.shape[1]
        device = self.cache.vols.device
        for lo in range(0, stop, self.batch_size):
            sel = order[lo:lo + self.batch_size]
            rows = self.rows[sel]
            drop = np.ones((len(sel), M), np.float32)
            if self.dropoff:
                for j, r in enumerate(rows):
                    pres = np.where(presence_np[r] > 0)[0]
                    if len(pres) > 1 and self.rng.random() > 0.8:
                        drop[j, self.rng.choice(pres)] = 0.0
            batch = gather_blocks(
                self.cache.vols, self.cache.tgts, self.cache.presence,
                torch.from_numpy(rows).to(device),
                torch.from_numpy(self.slices[sel]).to(device),
                torch.from_numpy(drop).to(device),
                block_size=self.cache.block_size)
            batch["subj_id"] = [self.cache.subjects[r] for r in rows]
            # int32, as the JAX package's loader emits it (and dumps it)
            batch["slice_idx"] = self.slices[sel].astype(np.int32)
            yield batch
