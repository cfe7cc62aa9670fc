"""Batch assembly with background prefetch (a copy of the JAX package's
``data/loader.py``; reference DataLoader with num_workers=0,
src/util.py:706-708).

Batches are gathered on a background thread (``SliceDataset.get_batch``:
the C++ gather or numpy; ``gather`` names the branch the last batch took)
and, with ``device``, copied there with ``.to(device)``, so that host work
overlaps the card's.  A worker exception is raised on the consuming thread; a
consumer that stops early ends the worker.

With ``shard`` (a data axis, parallel/mesh.py) each batch is the rank's
block of the global batch that the same shuffle gives every rank, and the
gather reads only those rows (JAX main_missing.py:321-324 shards the
global batch after the host built it); with the dataset's dropoff on, the
whole batch is gathered and cut, so that the dropoff draws stay the
unsharded ones.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

_POLL_S = 0.1


class BatchLoader:
    """Iterates dict batches: inputs [M, B, H, W, Cb], targets
    [B, H, W, Ct], mask [B, M], mask_img [B, H, W], slice_idx [B] (numpy
    arrays, or tensors on ``device``), subj_id list[B].

    Drops failed (None) samples like nonechucks.SafeDataset
    (src/util.py:702-704); a short final batch is dropped with
    ``drop_last`` (training) and kept otherwise (evaluation)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 10,
                 prefetch: int = 2, device=None, shard=None):
        if shard is not None and (not drop_last
                                  or batch_size % shard.size):
            raise ValueError("a sharded BatchLoader needs drop_last and a "
                             "batch size that divides by the mesh")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.device = device
        self.shard = shard

    @property
    def gather(self) -> Optional[str]:
        """"native" or "numpy": the branch of the dataset's batch gather
        that the last batch took (None before the first, or for a dataset
        without ``get_batch``)."""
        return getattr(self.dataset, "gather_branch", None)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _finish(self, batch: dict) -> dict:
        subj = batch.pop("subj_id")
        if self.device is not None:
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in batch.items()}
        batch["subj_id"] = subj
        return batch

    def _cut(self, batch: dict) -> dict:
        from representation_disentanglement_torch.parallel.mesh import (
            shard_batch)
        return shard_batch(batch, self.shard)

    def _collate(self, samples) -> dict:
        return self._finish(self._cut({
            "inputs": np.stack([s["inputs"] for s in samples], 1),
            "targets": np.stack([s["targets"] for s in samples], 0),
            "mask": np.stack([s["mask"] for s in samples], 0),
            "mask_img": np.stack([s["mask_img"] for s in samples], 0),
            "slice_idx": np.array([s["slice_idx"] for s in samples]),
            "subj_id": [s["subj_id"] for s in samples]}))

    def _batches(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        fast = getattr(self.dataset, "get_batch", None)
        if fast is not None:
            n = len(order)
            stop = (n // self.batch_size * self.batch_size
                    if self.drop_last else n)
            whole = self.shard is None or getattr(self.dataset, "dropoff",
                                                  False)
            for lo in range(0, stop, self.batch_size):
                idx = order[lo:lo + self.batch_size]
                if whole:
                    yield self._finish(self._cut(fast(idx.tolist())))
                else:
                    n = len(idx) // self.shard.size
                    r = self.shard.rank
                    yield self._finish(fast(idx[r * n:(r + 1) * n]
                                            .tolist()))
            return
        buf = []
        for idx in order:
            s = self.dataset[int(idx)]
            if s is None:
                continue
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._collate(buf)

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()
        err: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b in self._batches():
                    if not put(b):
                        return
            except Exception as e:          # raised on the consumer's thread
                err.append(e)
            put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            t.join()
        if err:
            raise err[0]
