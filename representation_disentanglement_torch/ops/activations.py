"""Activation resolution, including the reference's overwrite quirk (Q1).

Reference blocks build their activation with an ``if/if/if-else`` chain in
which every name but 'elu' falls into the final ``else`` and becomes the
identity (src/model.py:127-134).  ``resolve_block_act`` reproduces that;
``fix_bug=True`` gives the intended behaviour.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resolve_block_act(name: str, fix_bug: bool = False) -> str:
    if fix_bug:
        return name if name in ("lrelu", "relu", "elu") else "identity"
    return "elu" if name == "elu" else "identity"


def apply_act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "identity" or name == "no":
        return x
    if name == "lrelu":
        return F.leaky_relu(x, 0.2)
    if name == "relu":
        return F.relu(x)
    if name == "elu":
        return F.elu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "softplus":
        return F.softplus(x)
    raise ValueError(f"unknown activation {name!r}")
