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

Under a data mesh (``mesh_shape: {data: N}``) the train cache is sharded
over the ranks (``build_sharded_device_cache``: per-card bytes about 1/N)
and read by ``ShardedDeviceBatchLoader``; the val and test caches too,
read by ``ShardedEvalBatchLoader`` (``shard_eval_cache``), as JAX's
``device_store.py:198-482``.
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


# ---------------------------------------------------------------------------
# the cache sharded over a data mesh (JAX device_store.py:198-482)
# ---------------------------------------------------------------------------

class ShardedVolumeCache:
    """A volume cache sharded over the ranks of a data axis: subjects are
    dealt round-robin (subject g of the fold's unique subjects to rank
    g % N, at local row g // N), the list padded to N * S_loc with empty
    rows of presence 0, and each rank holds only its own
    ``vols`` [S_loc, M, D, H, W], ``tgts`` [S_loc, D, H, W] and
    ``presence`` [S_loc, M] on its device: per-card cache bytes are about
    1/N of the fold's.

    Every rank keeps the whole deal on the host: ``subjects`` (N * S_loc
    names in shard-major order, '' for padding), ``presence_np``
    [N, S_loc, M] and ``row`` (subject -> shard * S_loc + local row, the
    convention of the sharded epoch plan), so that every rank makes the
    same plan."""

    def __init__(self, vols, tgts, presence, presence_np, subjects,
                 block_size: int, clamp_hi: int, depth: int, axis):
        self.vols = vols
        self.tgts = tgts
        self.presence = presence
        self.presence_np = presence_np
        self.subjects = subjects
        self.row = {s: i for i, s in enumerate(subjects) if s}
        self.block_size = block_size
        self.clamp_hi = clamp_hi
        self.depth = depth
        self.axis = axis
        self.n_shards = presence_np.shape[0]
        self.s_loc = presence_np.shape[1]

    @property
    def nbytes_per_card(self) -> int:
        return self.vols.numel() * self.vols.element_size()

    @property
    def nbytes(self) -> int:                   # over the mesh
        return self.nbytes_per_card * self.n_shards


def build_sharded_device_cache(dataset_name: str, store: VolumeStore,
                               subj_list: Sequence[str],
                               contrast_list: Sequence[str], axis,
                               block_size: int = 3,
                               dtype: torch.dtype = torch.bfloat16,
                               budget_bytes: int = 12 * 2**30,
                               clamp_max: int = 155, device="cuda"
                               ) -> Optional[ShardedVolumeCache]:
    """``build_device_cache`` sharded over the data ``axis``: each rank
    packs and uploads only its subjects.  ``budget_bytes`` bounds one
    card's shard; None when it does not fit or no volume is present."""
    subjects = [str(s) for s in dict.fromkeys(np.asarray(subj_list).tolist())]
    probe = next((store.get(f"{s}/{c}") for s in subjects
                  for c in contrast_list if f"{s}/{c}" in store), None)
    if probe is None:
        return None
    H, W, D = probe.shape
    n, M = axis.size, len(contrast_list)
    s_loc = -(-len(subjects) // n)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if s_loc * M * D * H * W * itemsize > budget_bytes:
        return None
    padded = subjects + [""] * (n * s_loc - len(subjects))
    # round-robin: shard k holds subjects k, k + n, k + 2n, ...
    dealt = [padded[loc * n + k] for k in range(n) for loc in range(s_loc)]
    presence_np = np.array([[float(bool(s) and f"{s}/{c}" in store)
                             for c in contrast_list] for s in dealt],
                           np.float32).reshape(n, s_loc, M)
    mine = dealt[axis.rank * s_loc:(axis.rank + 1) * s_loc]
    real = [s for s in mine if s]
    vols = np.zeros((s_loc, M, D, H, W), np.float32)
    tgts = np.zeros((s_loc, D, H, W), np.float32)
    if real:
        packed = _pack_host(dataset_name, store, real, contrast_list)
        if packed is not None:
            vols[:len(real)], tgts[:len(real)] = packed[0], packed[1]
    return ShardedVolumeCache(
        torch.from_numpy(vols).to(device=device, dtype=dtype),
        torch.from_numpy(tgts).to(device),
        torch.from_numpy(presence_np[axis.rank]).to(device), presence_np,
        dealt, block_size, min(clamp_max, D), D, axis)


def _sample_groups(cache: ShardedVolumeCache, subj_list, idx_list):
    """Per shard, the (local row, clamped slice) of every sample whose
    subject it holds, in fold order: [N] arrays [k, 2] int64."""
    b = cache.block_size
    hi = min(cache.clamp_hi - b, cache.depth - b - 1)
    groups = [[] for _ in range(cache.n_shards)]
    for s, idx in zip(np.asarray(subj_list), np.asarray(idx_list)):
        shard, loc = divmod(cache.row[str(s)], cache.s_loc)
        groups[shard].append((loc, int(np.clip(idx, b, hi))))
    return [np.asarray(g, np.int64).reshape(-1, 2) for g in groups]


def _gather_local(cache: ShardedVolumeCache, rows, slices, drop) -> dict:
    """The rank's batch from its shard (JAX's per-device gather, :282)."""
    device = cache.vols.device
    return gather_blocks(cache.vols, cache.tgts, cache.presence,
                         torch.from_numpy(np.asarray(rows, np.int64)).to(
                             device),
                         torch.from_numpy(np.asarray(slices, np.int64)).to(
                             device),
                         torch.from_numpy(np.asarray(drop, np.float32)).to(
                             device), block_size=cache.block_size)


def _dropoff(presence_np, rows, drop, valid, rng) -> None:
    """The dropoff draw of JAX's sharded loaders, in their order: rows,
    drop [n_batches, N, b(, M)]; ``valid`` marks the rows that draw."""
    for i in range(rows.shape[0]):
        for n in range(rows.shape[1]):
            for j in range(rows.shape[2]):
                if not valid[i, n, j]:
                    continue
                pres = np.where(presence_np[n, rows[i, n, j]] > 0)[0]
                if len(pres) > 1 and rng.random() > 0.8:
                    drop[i, n, j, rng.choice(pres)] = 0.0


class ShardedDeviceBatchLoader:
    """Train batches over a ShardedVolumeCache: each global batch takes
    B / N samples from every shard's own subjects, so a rank gathers only
    from its shard.  A pass lasts as long as the smallest shard allows (the
    tails of larger shards are skipped; epochs reshuffle), as JAX's.  The
    batches are the rank's rows."""

    def __init__(self, cache: ShardedVolumeCache, subj_list, idx_list,
                 batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, dropoff: bool = False,
                 seed: int = 10):
        if batch_size % cache.n_shards:
            raise ValueError(f"batch_size {batch_size} must divide by the "
                             f"mesh size {cache.n_shards}")
        self.cache = cache
        self.batch_size = batch_size
        self.b_loc = batch_size // cache.n_shards
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.dropoff = dropoff
        self.rng = np.random.default_rng(seed)
        self.groups = _sample_groups(cache, subj_list, idx_list)

    @property
    def steps_per_pass(self) -> int:
        return min(len(g) for g in self.groups) // self.b_loc

    def __len__(self):
        return self.steps_per_pass

    def plan(self, n_batches: int):
        """The shuffled plan of every shard, the same on every rank: rows,
        slices [n_batches, N, b] (local rows) and drop [n_batches, N, b,
        M], from the loader's RNG in JAX's order."""
        N, b = self.cache.n_shards, self.b_loc
        rows = np.zeros((n_batches, N, b), np.int64)
        slices = np.zeros((n_batches, N, b), np.int64)
        M = self.cache.presence_np.shape[-1]
        drop = np.ones((n_batches, N, b, M), np.float32)
        for n, g in enumerate(self.groups):
            order = np.arange(len(g))
            if self.shuffle:
                self.rng.shuffle(order)
            sel = g[order[:n_batches * b]].reshape(n_batches, b, 2)
            rows[:, n] = sel[..., 0]
            slices[:, n] = sel[..., 1]
            if self.dropoff:
                _dropoff(self.cache.presence_np[n:n + 1], rows[:, n:n + 1],
                         drop[:, n:n + 1], np.ones((n_batches, 1, b), bool),
                         self.rng)
        return rows, slices, drop

    def __iter__(self):
        n_batches = self.steps_per_pass
        if n_batches == 0:
            return
        rows, slices, drop = self.plan(n_batches)
        r = self.cache.axis.rank
        for i in range(n_batches):
            batch = _gather_local(self.cache, rows[i, r], slices[i, r],
                                  drop[i, r])
            batch["subj_id"] = [self.cache.subjects[r * self.cache.s_loc + x]
                                for x in rows[i, r]]
            batch["slice_idx"] = slices[i, r].astype(np.int32)
            yield batch


class ShardedEvalBatchLoader:
    """One exhaustive pass over a ShardedVolumeCache for evaluation: every
    sample once, from the shard that holds its subject.  Every batch takes
    B / N rows of each shard; a shorter shard pads with repeats whose
    ``valid`` is 0 and whose mask is 0, so that they add nothing to a
    mask-gated loss and the metrics drop them.  The global batch is
    shard-major, not in fold order, as JAX's.  The batches are the rank's
    rows (``rank_local``; ``valid`` is the rank's too)."""

    rank_local = True

    def __init__(self, cache: ShardedVolumeCache, subj_list, idx_list,
                 batch_size: int, dropoff: bool = False, seed: int = 10):
        if batch_size % cache.n_shards:
            raise ValueError(f"batch_size {batch_size} must divide by the "
                             f"mesh size {cache.n_shards}")
        self.cache = cache
        self.batch_size = batch_size
        self.b_loc = batch_size // cache.n_shards
        self.dropoff = dropoff
        self.rng = np.random.default_rng(seed)
        self.groups = _sample_groups(cache, subj_list, idx_list)

    def __len__(self):
        return -(-max(len(g) for g in self.groups) // self.b_loc)

    def plan(self):
        """rows, slices, valid [n_batches, N, b] and drop [n_batches, N, b,
        M] (0 on the padding rows), the same on every rank."""
        N, b, n_batches = self.cache.n_shards, self.b_loc, len(self)
        M = self.cache.presence_np.shape[-1]
        rows = np.zeros((n_batches, N, b), np.int64)
        slices = np.zeros((n_batches, N, b), np.int64)
        valid = np.zeros((n_batches, N, b), bool)
        for n, g in enumerate(self.groups):
            k = len(g)
            if k:
                rows[:, n] = np.resize(g[:, 0], n_batches * b).reshape(
                    n_batches, b)
                slices[:, n] = np.resize(g[:, 1], n_batches * b).reshape(
                    n_batches, b)
            else:                       # a shard with no eval subject
                slices[:, n] = self.cache.block_size
            v = np.zeros(n_batches * b, bool)
            v[:k] = True
            valid[:, n] = v.reshape(n_batches, b)
        drop = valid[..., None].astype(np.float32) * np.ones(
            (1, 1, 1, M), np.float32)
        if self.dropoff:
            _dropoff(self.cache.presence_np, rows, drop, valid, self.rng)
        return rows, slices, valid, drop

    def __iter__(self):
        rows, slices, valid, drop = self.plan()
        r = self.cache.axis.rank
        for i in range(rows.shape[0]):
            batch = _gather_local(self.cache, rows[i, r], slices[i, r],
                                  drop[i, r])
            batch["subj_id"] = [self.cache.subjects[r * self.cache.s_loc + x]
                                for x in rows[i, r]]
            batch["slice_idx"] = slices[i, r].astype(np.int32)
            batch["valid"] = valid[i, r]
            yield batch
