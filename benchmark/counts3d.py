"""The yardstick's counts for NVNet3D: the FLOP of a training step,
counted on the plain reference (``reference/nvnet3d.py``) so that no
change to how the program implements the step moves them, and the card's
dense TF32 peak, the precision cuDNN runs float32 convolutions in by
PyTorch's default.
"""

from __future__ import annotations

from typing import Optional

import torch

# Dense TF32 peaks (no sparsity), operations per second, by the name
# torch.cuda.get_device_name gives (matched as a substring): half of the
# H100 data sheet's with-sparsity TF32 figures, SXM5 989.4, PCIe 756,
# NVL 835 TFLOP/s, at each part's full power limit.
TF32_PEAKS = (
    ("H100 80GB HBM3", 494.7e12),
    ("H100 PCIe", 378e12),
    ("H100 NVL", 417.5e12),
)


def tf32_peak(device_name: str) -> Optional[float]:
    for key, peak in TF32_PEAKS:
        if key in device_name:
            return peak
    return None


def forward_flop(cfg: dict, batch: int) -> float:
    """FLOP of one forward of the reference on ``batch`` crops: its
    convolutions and matrix products, 2 per multiply-add, as
    ``torch.utils.flop_counter`` counts them (normalization, upsampling
    and elementwise work are not counted), on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import nvnet3d
    dev = torch.device("meta")
    P = {n: torch.empty(s, device=dev)
         for n, s, _ in nvnet3d.param_specs(cfg)}
    x = torch.empty((batch, len(cfg["contrast_list"]), *cfg["image_size"]),
                    device=dev)
    with FlopCounterMode(display=False) as fc:
        nvnet3d.forward(P, cfg, x, train=False)
    return float(fc.get_total_flops())


def train_step_flop(cfg: dict, batch: int, n_micro: int) -> float:
    """FLOP of one optimizer step of ``n_micro`` microbatches of ``batch``
    crops: the forward and its backward, whose two products per forward
    product make three forwards."""
    return 3.0 * forward_flop(cfg, batch) * n_micro
