"""Missing-modality serving: the imputation product as an entry point.

``make_serve_step`` is the counterpart of the JAX package's
``serve.make_serve_step``: one call of ``MultimodalModel.synthesize`` (M
decodes from one anatomy source plus the fused y decode) on a batch whose
absent contrasts are zero-filled.  ``serve_requests`` answers a request on
in-memory slice blocks with the request rules of the JAX serving loop
(serve.py:165-180, 283-307 there): contrasts named by ``missing`` are
zero-filled and their mask columns cleared, the background mask comes from
contrast 0 (or from ``source`` when contrast 0 is missing), the tail batch
is padded by repeating its last row, and the centre slice of each block is
kept.

Example (on the card)::

    from representation_disentanglement_torch import config, serve
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    cfg = config.flagship()
    model = build_model(cfg)                  # CUDA; device="cpu" for CPU
    out = serve.serve_requests(model, cfg, inputs, missing=["T1"])
    out["x_hat"]["T1"]                        # [N, H, W] synthesized T1
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from representation_disentanglement_torch.config import Config


def make_serve_step(model, cfg: Config, source: int, with_y: bool = True):
    """Returns ``step(inputs, mask, mask_img) -> (x_hat, y)``.

    inputs [M, B, H, W, Cb] (absent contrasts zero-filled), mask [B, M],
    mask_img [B, H, W], as numpy arrays or tensors; x_hat [M, B, H, W, Cb]
    and y [B, H, W, out] come back as f32 tensors on the model's device
    (y is None when ``with_y`` is off: the fused decode is skipped)."""
    bf16 = cfg.compute_dtype == "bfloat16"
    dev = model.device

    def step(inputs, mask, mask_img):
        with torch.inference_mode():
            x = torch.as_tensor(inputs, device=dev)
            if bf16:
                x = x.to(torch.bfloat16)
            m = torch.as_tensor(mask, device=dev, dtype=torch.float32)
            mi = torch.as_tensor(mask_img, device=dev, dtype=torch.float32)
            x_hat, y = model.synthesize(x, m, mi, source=source,
                                        with_y=with_y)
            return x_hat.float(), (y.float() if with_y else None)

    return step


def resolve_request(contrasts: Sequence[str], missing: Sequence[str],
                    source: Optional[str]):
    """(missing indices, source index) by contrast name."""
    contrasts = list(contrasts)
    miss_idx = []
    for m in missing:
        if m not in contrasts:
            raise ValueError(f"missing contrast {m!r} not in {contrasts}")
        miss_idx.append(contrasts.index(m))
    if source is None:
        present = [c for c in contrasts if c not in missing]
        if not present:
            raise ValueError("every contrast is missing; nothing to anchor "
                             "the anatomy on")
        source = present[0]
    if source in missing:
        raise ValueError(f"source {source!r} is in missing")
    if source not in contrasts:
        raise ValueError(f"source {source!r} not in {contrasts}")
    return miss_idx, contrasts.index(source)


def serve_requests(model, cfg: Config, inputs: np.ndarray,
                   missing: Sequence[str], source: Optional[str] = None,
                   batch: Optional[int] = None) -> Dict:
    """Synthesize the ``missing`` contrasts of N slice blocks.

    inputs: [M, N, H, W, Cb] f32, every contrast present before ``missing``
    is applied.  Returns
    {"x_hat": {contrast: [N, H, W]} for the missing contrasts and the
    source, "y": [N, H, W], "steps": serve steps run, "source": name}."""
    contrasts = list(cfg.contrast_list)
    miss_idx, src_idx = resolve_request(contrasts, missing, source)
    B = batch or cfg.batch_size
    M, N = inputs.shape[:2]
    if M != len(contrasts):
        raise ValueError(f"inputs hold {M} contrasts; config has "
                         f"{len(contrasts)}")
    step = make_serve_step(model, cfg, src_idx, with_y=True)
    keep_idx = miss_idx + ([src_idx] if src_idx not in miss_idx else [])
    ref_mod = 0 if 0 not in miss_idx else src_idx
    centre = cfg.block_size
    per_mod = {mi: [] for mi in keep_idx}
    y_slices = []
    steps = 0
    for lo in range(0, N, B):
        rows = list(range(lo, min(lo + B, N)))
        n_valid = len(rows)
        rows += [rows[-1]] * (B - n_valid)
        x = inputs[:, rows].astype(np.float32, copy=True)
        m = np.ones((B, M), np.float32)
        for mi in miss_idx:
            x[mi] = 0.0
            m[:, mi] = 0.0
        mask_img = (x[ref_mod, :, :, :, 0] == 0).astype(np.float32)
        x_hat, y = step(x, m, mask_img)
        kept = x_hat[keep_idx, :n_valid, :, :, centre].cpu().numpy()
        for k, mi in enumerate(keep_idx):
            per_mod[mi].append(kept[k])
        y_slices.append(y[:n_valid].cpu().numpy())
        steps += 1
    yv = np.concatenate(y_slices, axis=0)                  # [N, H, W, C]
    if cfg.dataset_name == "BraTS" and yv.shape[-1] >= 4:
        # label map by the reference's per-class rule (src/util.py:946-953)
        fg = yv[..., 1:4]
        yv = (np.argmax(fg, axis=-1) + 1).astype(np.float32) \
            * (np.max(fg, axis=-1) > 0.5)
    else:
        yv = yv[..., 0]
    return {"x_hat": {contrasts[mi]: np.concatenate(per_mod[mi], axis=0)
                      for mi in keep_idx},
            "y": yv, "steps": steps, "source": contrasts[src_idx]}
