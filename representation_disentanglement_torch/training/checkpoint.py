"""Checkpoint I/O with the reference's contract (reference
src/util.py:148-170, 870-903; src/main_missing.py:326-335; JAX
``training/checkpoint.py``).

A checkpoint is ``torch.save`` of a dict with the JAX package's logical
keys: ``epoch``, ``monitor_metric``, ``stat``, ``params`` (the model's
``state_dict``, reference torch names, BatchNorm buffers included),
``opt_state`` (``optimizer.state_dict()``), ``opt_d_state`` (the
discriminator's Adam, None without one) and ``scheduler``.  Files are
named as in the JAX package (``epochNNN.ckpt``, ``model_best.ckpt``,
``preempt.ckpt``), but the two packages' files are not interchangeable:
the JAX package writes msgpack; ``weights.from_jax_params`` carries JAX
parameters into the port.

Writes are atomic (a tmp file, then ``os.replace``); ``model_best.ckpt`` is
a copy.  Loading uses ``torch.load(weights_only=True)`` onto the CPU.
``load_partial_params`` is the reference's shape-tolerant merge
(``load_checkpoint_model``, src/util.py:895-903) on flat state dicts.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import torch


def save_checkpoint(state_dict: Dict[str, Any], is_best: bool,
                    ckpt_path: str, name: Optional[str] = None) -> str:
    os.makedirs(ckpt_path, exist_ok=True)
    epoch = int(state_dict.get("epoch", 0))
    name = name or f"epoch{epoch:03d}.ckpt"
    path = os.path.join(ckpt_path, name)
    tmp = path + ".tmp"
    torch.save(state_dict, tmp)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, os.path.join(ckpt_path, "model_best.ckpt"))
    return path


def load_checkpoint(ckpt_path: str, ckpt_name: str = "model_best.ckpt"
                    ) -> Dict[str, Any]:
    filename = os.path.join(ckpt_path, ckpt_name)
    if not os.path.isfile(filename):
        raise ValueError(f"No correct checkpoint at {filename}")
    return torch.load(filename, map_location="cpu", weights_only=True)


def load_partial_params(current: Mapping[str, torch.Tensor],
                        saved: Optional[Mapping[str, torch.Tensor]]
                        ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Shape-filtered merge: keep each saved tensor whose name is in
    ``current`` with the same shape, and the current one elsewhere.
    Returns (merged, n_restored, n_total_current)."""
    saved = saved or {}
    restored = 0
    out = {}
    for k, v in current.items():
        sv = saved.get(k)
        if sv is not None and tuple(sv.shape) == tuple(v.shape):
            out[k] = sv
            restored += 1
        else:
            out[k] = v
    return out, restored, len(current)


def restore_model_state(current: Mapping[str, torch.Tensor], ckpt_path: str,
                        ckpt_name: str = "model_best.ckpt"
                        ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor],
                                   int, int]:
    """The shared half of the resume protocol: load a checkpoint and merge
    its ``params`` into the current ``state_dict``.  Returns (checkpoint
    dict, merged state dict, n_restored, n_total), so that callers restore
    the optimizer, schedule and epoch with their own tolerance rules."""
    ckpt = load_checkpoint(ckpt_path, ckpt_name)
    merged, n_res, n_tot = load_partial_params(current, ckpt.get("params"))
    return ckpt, merged, n_res, n_tot
