"""The epoch loop over the device volume cache (JAX ``training/epoch.py``,
unsharded cache).

At the start of an epoch the host plans every optimizer step
(``epoch_indices``): the shuffled (row, slice) indices grouped into
[steps, A, B], the dropoff draws and the sim/adv modality pairs, consuming
the loader's and the pair generator's numpy RNGs in the JAX package's
order, so that both packages plan the same epoch from the same seeds.
The rows, slices and dropoff go to the device in one copy; the pairs stay
on the host, where the losses index with them.

``train_epoch`` then runs each step of a chunk of the plan as
``training.train.make_train_step`` does (the adversarial step and the
stage-2 freeze included), on microbatches gathered from the cache on the
device (``data.device_store.gather_blocks``), and returns the per-step
metrics as one [steps, len(METRIC_KEYS)] tensor on the device.
Nothing in the loop reads a value back to the host: the caller fetches
the metrics once per epoch.

Under a data mesh each rank runs the plan's rows of its own: the rank's
block of every batch of a replicated cache's plan
(``parallel.mesh.shard_epoch_plan``), or, over the sharded cache, the
rank's column of the locality-aware plan (``_epoch_indices_sharded``, JAX
training/epoch.py:231), whose rows index the rank's shard.  Either plan is
made from the seeds on every rank alike.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from representation_disentanglement_torch.data.device_store import (
    DeviceBatchLoader, DeviceVolumeCache, ShardedDeviceBatchLoader,
    gather_blocks)
from representation_disentanglement_torch.training.train import (
    draw_pairs, make_train_step)


class EpochPlan(NamedTuple):
    """rows, slices: int64 [steps, A, B] and drop: f32 [steps, A, B, M] on
    the device; sim, adv: int32 [steps, A, 2] numpy."""
    rows: torch.Tensor
    slices: torch.Tensor
    drop: torch.Tensor
    sim: np.ndarray
    adv: np.ndarray

    @property
    def steps(self) -> int:
        return self.rows.shape[0]

    def chunk(self, lo: int, hi: int) -> "EpochPlan":
        """The plan of steps lo..hi-1."""
        return EpochPlan(*(p[lo:hi] for p in self))


def make_train_epoch(model, cfg, optimizer: torch.optim.Optimizer,
                     cache: DeviceVolumeCache,
                     generator: Optional[torch.Generator],
                     d_optimizer: Optional[torch.optim.Optimizer] = None,
                     mesh=None):
    """Returns ``(train_epoch, n_micro)``.  ``train_epoch(plan,
    first_chunk)`` runs the steps of ``plan`` (an ``EpochPlan`` or a chunk
    of one); ``first_chunk`` says that its step 0 is the epoch's first,
    which also decodes y (reference main_missing.py:182).  ``generator``
    is the device generator that ``sample_z`` draws from; ``d_optimizer``
    the discriminator's Adam, with ``lambda_adv_s > 0``; ``mesh`` the data
    axis (``cache`` then the rank's: replicated or sharded)."""
    step = make_train_step(model, cfg, optimizer, d_optimizer, mesh)
    n_micro = max(cfg.effective_batch // cfg.batch_size, 1)

    def gather(rows, slices, drop):
        return gather_blocks(cache.vols, cache.tgts, cache.presence, rows,
                             slices, drop, block_size=cache.block_size)

    def train_epoch(plan: EpochPlan, first_chunk: bool) -> torch.Tensor:
        metrics = []
        for i in range(plan.steps):
            mbs = [gather(plan.rows[i, a], plan.slices[i, a],
                          plan.drop[i, a]) for a in range(n_micro)]
            stacked = {k: torch.stack([mb[k] for mb in mbs])
                       for k in ("inputs", "targets", "mask", "mask_img")}
            metrics.append(step(stacked, generator, plan.sim[i], plan.adv[i],
                                first_of_epoch=first_chunk and i == 0))
        return torch.stack(metrics)

    return train_epoch, n_micro


def epoch_indices(loader: DeviceBatchLoader, n_micro: int,
                  modality_num: int, pair_rng: np.random.Generator
                  ) -> Optional[EpochPlan]:
    """The plan of one epoch, or None when the loader holds fewer samples
    than one optimizer step takes.  Over the sharded cache, the rank's
    part of the sharded plan."""
    if isinstance(loader, ShardedDeviceBatchLoader):
        return _epoch_indices_sharded(loader, n_micro, modality_num,
                                      pair_rng)
    cache = loader.cache
    order = np.arange(len(loader.rows))
    if loader.shuffle:
        loader.rng.shuffle(order)
    B = loader.batch_size
    per_step = B * n_micro
    n_steps = len(order) // per_step
    if n_steps == 0:
        return None
    sel = order[:n_steps * per_step].reshape(n_steps, n_micro, B)
    rows = loader.rows[sel]
    slices = loader.slices[sel]
    M = cache.presence_np.shape[1]
    drop = np.ones((n_steps, n_micro, B, M), np.int64)
    if loader.dropoff:
        flat_drop = drop.reshape(-1, M)
        for j, r in enumerate(rows.reshape(-1)):
            pres = np.where(cache.presence_np[r] > 0)[0]
            if len(pres) > 1 and loader.rng.random() > 0.8:
                flat_drop[j, loader.rng.choice(pres)] = 0
    sim = np.stack([draw_pairs(pair_rng, modality_num, n_micro)
                    for _ in range(n_steps)])
    adv = np.stack([draw_pairs(pair_rng, modality_num, n_micro)
                    for _ in range(n_steps)])
    return _upload(cache, rows, slices, drop, sim, adv)


def _upload(cache, rows, slices, drop, sim, adv) -> EpochPlan:
    # one host-to-device copy: [steps, A, B, 2 + M] of rows, slices, drop
    packed = np.concatenate([rows[..., None], slices[..., None],
                             drop.astype(np.int64)], -1)
    dev = torch.from_numpy(packed).to(cache.vols.device)
    return EpochPlan(dev[..., 0], dev[..., 1], dev[..., 2:].float(), sim,
                     adv)


def _epoch_indices_sharded(loader: ShardedDeviceBatchLoader, n_micro: int,
                           modality_num: int,
                           pair_rng: np.random.Generator
                           ) -> Optional[EpochPlan]:
    """The locality-aware plan over the sharded cache (JAX
    ``_epoch_indices_sharded``): ``loader.plan`` of steps * A batches as
    [steps, A, N, b], the pairs after it; the rank keeps its column, rows
    of its own shard."""
    A, b = n_micro, loader.b_loc
    n_steps = min(len(g) for g in loader.groups) // (A * b)
    if n_steps == 0:
        return None
    rows, slices, drop = loader.plan(n_steps * A)
    sim = np.stack([draw_pairs(pair_rng, modality_num, A)
                    for _ in range(n_steps)])
    adv = np.stack([draw_pairs(pair_rng, modality_num, A)
                    for _ in range(n_steps)])
    r = loader.cache.axis.rank
    cut = lambda a: a.reshape((n_steps, A) + a.shape[1:])[:, :, r]
    return _upload(loader.cache, cut(rows), cut(slices), cut(drop), sim,
                   adv)
