"""ResNet18 amyloid-status classifier (JAX ``models/resnet.py``; reference
``ResNet18``, src/model.py:1591-1601: torchvision's resnet18 with the fc
replaced by Linear(512, num_outputs) and a sigmoid head).

torchvision's layout and parameter names: conv7x7/2 ``conv1`` -> ``bn1``
-> ReLU -> maxpool 3x3/2 (padding 1, which pads with -inf) -> ``layer1`` ..
``layer4`` of two ``BasicBlock``s each (64/128/256/512, stride 2 between
stages, a 1x1 + BN ``downsample`` on the first block of stages 2-4) ->
global mean -> ``fc`` -> sigmoid.  So a torchvision ``state_dict`` (or an
npz of one, ``dump_torchvision_resnet18``) loads through
``load_resnet18_params``.  Train-mode BatchNorms are one group.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from representation_disentanglement_torch.models.layers import (
    BatchNormTorch, MaybeCondConv, TorchLinear, resolve_device)
from representation_disentanglement_torch.models.legacy import default_gen


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1, *,
                 gen: torch.Generator):
        super().__init__()
        f = features
        self.conv1 = MaybeCondConv(in_ch, f, 3, stride, 1, gen=gen,
                                   bias=False)
        self.bn1 = BatchNormTorch(f)
        self.conv2 = MaybeCondConv(f, f, 3, 1, 1, gen=gen, bias=False)
        self.bn2 = BatchNormTorch(f)
        self.downsample = None
        if stride != 1 or in_ch != f:
            self.downsample = nn.Sequential(
                MaybeCondConv(in_ch, f, 1, stride, 0, gen=gen, bias=False),
                BatchNormTorch(f))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(h + x)


class ResNet18(nn.Module):
    """Binary classifier head (sigmoid), torchvision-resnet18 body:
    x [B, in_ch, H, W] -> probabilities [B, num_outputs]."""

    def __init__(self, in_ch: int = 3, num_outputs: int = 1, *,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        gen = default_gen(gen)
        self.conv1 = MaybeCondConv(in_ch, 64, 7, 2, 3, gen=gen, bias=False)
        self.bn1 = BatchNormTorch(64)
        prev = 64
        for stage, (f, s) in enumerate([(64, 1), (128, 2), (256, 2),
                                        (512, 2)], start=1):
            setattr(self, f"layer{stage}", nn.Sequential(
                BasicBlock(prev, f, s, gen=gen),
                BasicBlock(f, f, 1, gen=gen)))
            prev = f
        self.fc = TorchLinear(512, num_outputs, gen)
        self.to(resolve_device(device))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, padding=1)
        for stage in range(1, 5):
            h = getattr(self, f"layer{stage}")(h)
        return torch.sigmoid(self.fc(h.mean(dim=(-2, -1))))


def dump_torchvision_resnet18(npz_path: str) -> None:
    """Where torchvision is installed: write its pretrained resnet18's
    ``state_dict`` as an npz for ``load_resnet18_params``."""
    import torchvision
    m = torchvision.models.resnet18(pretrained=True)
    np.savez(npz_path, **{k: v.detach().numpy()
                          for k, v in m.state_dict().items()})


def load_resnet18_params(model: ResNet18, sd: Dict) -> list:
    """Load a torchvision resnet18 ``state_dict``-style mapping (tensors or
    arrays) into ``model``.  The fc is taken only when its rows match the
    model's ``num_outputs`` (the reference replaces torchvision's 1000-way
    head, src/model.py:1595); ``num_batches_tracked`` is not kept.  Raises
    on any other key missing or left over; returns the keys loaded."""
    rows = model.fc.weight.shape[0]
    out = {k: torch.as_tensor(np.asarray(v, np.float32))
           for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    if "fc.weight" in out and out["fc.weight"].shape[0] != rows:
        del out["fc.weight"], out["fc.bias"]
    res = model.load_state_dict(out, strict=False)
    missing = set(res.missing_keys) - {"fc.weight", "fc.bias"}
    if missing or res.unexpected_keys:
        raise ValueError(f"not a resnet18 state_dict: missing "
                         f"{sorted(missing)[:5]}, unexpected "
                         f"{res.unexpected_keys[:5]}")
    return sorted(out)
