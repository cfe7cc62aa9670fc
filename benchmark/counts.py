"""The yardstick's counts: the card's peaks, the FLOP of a cell's step or
request (counted on the plain reference, so that no change to how the
program implements a step moves them), and the bytes and FLOP of the
``rdt::in_modulate`` ops from their argument shapes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark.inputs import meta_reference

# Dense peaks (no sparsity), operations per second, and HBM bandwidth, by
# the name torch.cuda.get_device_name gives (matched as a substring).
# NVIDIA H100 data sheet: SXM5 at its 700 W limit, 989.4 TFLOP/s bf16 on
# the tensor cores, 66.9 TFLOP/s float32 outside them, 3.35 TB/s HBM3;
# PCIe (350 W) 756 / 51.2 TFLOP/s, 2.0 TB/s; NVL (400 W) 835 / 60
# TFLOP/s, 3.9 TB/s.  A card run under a lower power limit reaches less:
# the run prints the limit beside the name.
PEAKS = (
    ("H100 80GB HBM3", {"bfloat16": 989.4e12, "float32": 66.9e12,
                        "hbm": 3.35e12}),
    ("H100 PCIe", {"bfloat16": 756e12, "float32": 51.2e12, "hbm": 2.0e12}),
    ("H100 NVL", {"bfloat16": 835e12, "float32": 60e12, "hbm": 3.9e12}),
)

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    for key, p in PEAKS:
        if key in device_name:
            return p
    return None


# ---- rdt::in_modulate -------------------------------------------------
# Per element of zi: the forward reads zi, gamma and beta and writes the
# result; its plain math is 8 operations (mean, centred square, scale by
# the reciprocal deviation, 1 + gamma, product, sum).  The backward reads
# zi, gamma and the incoming gradient and writes dz and dgamma (dbeta is
# the incoming gradient itself); 12 operations.
IN_MODULATE = {"rdt::in_modulate": (4, 8.0),
               "rdt::in_modulate_bwd": (5, 12.0)}


def in_modulate_cost(op: str, zi_shape, dtype: str):
    """(bytes, FLOP) of one call of ``op`` on a zi of ``zi_shape`` whose
    tensors are all in ``dtype``."""
    tensors, flop_per = IN_MODULATE[op]
    n = math.prod(zi_shape)
    return tensors * n * DTYPE_BYTES[dtype], flop_per * n


def least_time(bytes_, flop, peak: Dict[str, float], dtype: str) -> float:
    """The roofline's least time: the larger of bytes over HBM bandwidth
    and FLOP over the dtype's peak."""
    return max(bytes_ / peak["hbm"], flop / peak[dtype])


# ---- FLOP of a step or a request, on the reference ---------------------

def train_step_flop(cfg: dict, micro: int, n_micro: int) -> float:
    """FLOP of one optimizer step of ``n_micro`` microbatches of ``micro``
    slice blocks: the reference's training forward and its backward
    (convolutions and matrix products, 2 per multiply-add, as
    ``torch.utils.flop_counter`` counts them; resizes and elementwise work
    are not counted), on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.train import losses
    ref = meta_reference(cfg)
    ref.train()
    M = len(cfg["contrast_list"])
    H, W, cb = cfg["input_height"], cfg["input_width"], 2 * cfg[
        "block_size"] + 1
    needs_y = cfg["lambda_recon_y"] > 0 or cfg["lambda_recon_y_fused"] > 0
    dev = torch.device("meta")
    batch = {"inputs": torch.empty(M, micro, H, W, cb, device=dev),
             "mask": torch.empty(micro, M, device=dev),
             "mask_img": torch.empty(micro, H, W, device=dev),
             "targets": torch.empty(micro, H, W, 1, device=dev)}
    params = list(ref.parameters())
    with FlopCounterMode(display=False) as fc:
        out = ref.forward_train(batch["inputs"], batch["mask"],
                                batch["mask_img"],
                                torch.empty(M, micro, cfg["z_size"],
                                            device=dev), needs_y)
        loss = losses(cfg, batch, out, (0, 1))["all"]
        torch.autograd.grad(loss, params, allow_unused=True)
    return float(fc.get_total_flops()) * n_micro


def request_flop(cfg: dict, batch: int) -> float:
    """FLOP of one imputation request of ``batch`` slice blocks: the
    reference's ``synthesize`` from one source with the fused y decode."""
    from torch.utils.flop_counter import FlopCounterMode
    ref = meta_reference(cfg)
    ref.eval()
    M = len(cfg["contrast_list"])
    H, W, cb = cfg["input_height"], cfg["input_width"], 2 * cfg[
        "block_size"] + 1
    dev = torch.device("meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.synthesize(torch.empty(M, batch, H, W, cb, device=dev),
                       torch.empty(batch, M, device=dev),
                       torch.empty(batch, H, W, device=dev), 0)
    return float(fc.get_total_flops())
