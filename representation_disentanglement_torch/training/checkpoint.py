"""Checkpoint I/O with the reference's contract (reference
src/util.py:148-170, 870-903; src/main_missing.py:326-335; JAX
``training/checkpoint.py``).

A checkpoint is ``torch.save`` of a dict with the JAX package's logical
keys: ``epoch``, ``monitor_metric``, ``stat``, ``params`` (the model's
``state_dict``, reference torch names, BatchNorm buffers included),
``opt_state`` (``optimizer.state_dict()``), ``opt_d_state`` (the
discriminator's Adam, None without one) and ``scheduler``.  Files are
named as in the JAX package (``epochNNN.ckpt``, ``model_best.ckpt``,
``preempt.ckpt``).

``load_checkpoint`` also reads the JAX package's files (flax msgpack of
the same keys, ``training/flax_msgpack.py``), told apart by their first
bytes: ``PK\x03\x04`` is a ``torch.save`` zip, a msgpack map begins with
0x80-0x8f, 0xde or 0xdf.  A JAX file comes back with ``format: "jax"``,
its trees as JAX wrote them, and its scalars (``epoch``,
``monitor_metric``, ``monitor_is_val_dice``, the ``stat`` and
``scheduler`` leaves: 0-d arrays in the file) as Python numbers;
``from_jax_checkpoint`` then converts the trees into the port's form: the
parameters through a ``weights.from_jax_*`` function, the optimizer states
(flax's state dict of ``AdamAmsgradState``: ``count``, ``mu``, ``nu``,
``nu_max``; ``opt_d_state`` {} without a discriminator) through the same
name and layout mapping into ``optim.adam_state_from_jax``'s form, which
``optim.load_adam_state`` loads into torch Adam.

Writes are atomic (a tmp file, then ``os.replace``); ``model_best.ckpt`` is
a copy.  Loading uses ``torch.load(weights_only=True)`` onto the CPU.
``load_partial_params`` is the reference's shape-tolerant merge
(``load_checkpoint_model``, src/util.py:895-903) on flat state dicts.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from representation_disentanglement_torch.training import flax_msgpack
from representation_disentanglement_torch.training.optim import (
    adam_state_from_jax)

_ZIP = b"PK\x03\x04"
# the keys whose leaves the JAX package saves as 0-d arrays and the port
# reads as numbers
_SCALAR_KEYS = ("epoch", "monitor_metric", "monitor_is_val_dice", "stat",
                "scheduler")


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


def _numbers(node):
    """0-d arrays (and numpy scalars) -> Python numbers, through dicts."""
    if isinstance(node, dict):
        return {k: _numbers(v) for k, v in node.items()}
    if isinstance(node, (np.ndarray, np.generic, torch.Tensor)) \
            and node.ndim == 0:
        return node.item()
    return node


def load_checkpoint(ckpt_path: str, ckpt_name: str = "model_best.ckpt"
                    ) -> Dict[str, Any]:
    """A checkpoint of either package (module docstring)."""
    filename = os.path.join(ckpt_path, ckpt_name)
    if not os.path.isfile(filename):
        raise ValueError(f"No correct checkpoint at {filename}")
    with open(filename, "rb") as f:
        head = f.read(4)
    if head == _ZIP:
        return torch.load(filename, map_location="cpu", weights_only=True)
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        with open(filename, "rb") as f:
            tree = flax_msgpack.restore(f.read())
        out = {k: (_numbers(v) if k in _SCALAR_KEYS else v)
               for k, v in tree.items()}
        out["format"] = "jax"
        return out
    raise ValueError(f"{filename} is neither a torch.save checkpoint nor a "
                     "JAX package (flax msgpack) one")


def _f32_numpy(node):
    """A JAX tree with numpy f32 leaves (bfloat16 tensors upcast)."""
    if isinstance(node, dict):
        return {k: _f32_numpy(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node.float().numpy()
    return np.asarray(node, np.float32)


def from_jax_checkpoint(ckpt: Dict[str, Any],
                        params_fn: Callable[[Dict, Optional[Dict]],
                                            Dict[str, torch.Tensor]],
                        param_names: Sequence[str]) -> Dict[str, Any]:
    """The port's form of a checkpoint that ``load_checkpoint`` read from
    a JAX file (any other comes back as it is).  ``params_fn(params,
    batch_stats)`` is the model's ``weights.from_jax_*`` conversion, which
    with ``batch_stats=None`` maps a tree of the parameters' structure to
    {port name: tensor}; ``param_names`` orders the optimizer state as
    ``model.named_parameters()``."""
    if ckpt.get("format") != "jax":
        return ckpt
    out = {k: v for k, v in ckpt.items()
           if k not in ("params", "batch_stats", "opt_state",
                        "opt_d_state")}
    stats = ckpt.get("batch_stats") or None
    out["params"] = params_fn(_f32_numpy(ckpt["params"]),
                              None if stats is None else _f32_numpy(stats))
    for key in ("opt_state", "opt_d_state"):
        state = ckpt.get(key)
        if state:                  # {} without the discriminator
            out[key] = adam_state_from_jax(
                {k: (v if k == "count" else
                     params_fn(_f32_numpy(v), None))
                 for k, v in state.items()}, param_names)
    return out


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
                        ckpt_name: str = "model_best.ckpt", *,
                        params_fn=None, param_names: Sequence[str] = ()
                        ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor],
                                   int, int]:
    """The shared half of the resume protocol: load a checkpoint (a JAX
    one converted by ``from_jax_checkpoint`` with ``params_fn`` and
    ``param_names``) and merge its ``params`` into the current
    ``state_dict``.  Returns (checkpoint dict, merged state dict,
    n_restored, n_total), so that callers restore the optimizer, schedule
    and epoch with their own tolerance rules."""
    ckpt = load_checkpoint(ckpt_path, ckpt_name)
    if ckpt.get("format") == "jax":
        if params_fn is None:
            raise ValueError(f"{ckpt_name} is a JAX package checkpoint; "
                             "restoring it needs the model's params_fn")
        ckpt = from_jax_checkpoint(ckpt, params_fn, param_names)
    merged, n_res, n_tot = load_partial_params(current, ckpt.get("params"))
    return ckpt, merged, n_res, n_tot
