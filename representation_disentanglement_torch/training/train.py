"""The training step, with the JAX package's semantics (JAX
training/train.py:72-134, 192-293; reference src/main_missing.py:141-335).

One call of the step consumes A = effective_batch // batch_size
microbatches stacked on a leading axis:

    for a in range(A):  g_acc = clip(g_acc + grad(microbatch a))
    params <- Adam(amsgrad)(g_acc)

The reference clips the *accumulated* gradient after every microbatch
(main_missing.py:272).  BatchNorm running statistics thread through the
microbatches in order.  ``compute_y`` follows the reference's "decode y
only at iteration 0 unless a y-loss is on" rule (main_missing.py:182-190);
with the shipped losses it only decides which BN statistics move.

Under ``compute_dtype: bfloat16`` the inputs are cast to bf16 once per
microbatch; parameters, optimizer state, BN statistics and the loss sums
stay f32.  The step returns the metrics as one stacked f32 tensor on the
device, in the order ``METRIC_KEYS``; ``metrics_to_dict`` reads it with one
host sync.

Example (on the card)::

    from representation_disentanglement_torch import config
    from representation_disentanglement_torch.models.multimodal import (
        build_model)
    from representation_disentanglement_torch.training.optim import (
        make_optimizer)
    from representation_disentanglement_torch.training.train import (
        draw_pairs, make_train_step, metrics_to_dict)
    cfg = config.flagship()
    model = build_model(cfg)                      # CUDA; device="cpu" too
    step = make_train_step(model, cfg, make_optimizer(model.parameters(),
                                                      cfg))
    gen = torch.Generator(device=model.device).manual_seed(0)
    pairs = draw_pairs(np.random.default_rng(0), cfg.modality_num, 1)
    metrics = metrics_to_dict(step(batch, gen, pairs, first_of_epoch=True))
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from representation_disentanglement_torch import losses as L
from representation_disentanglement_torch.training.optim import (
    clip_global_norm)

LOSS_KEYS = ("recon_y", "recon_y_fused", "recon_x", "recon_x_mix", "kl",
             "latent_z", "sim_s", "sim_z", "adv_s", "adv_s_d", "all")
METRIC_KEYS = LOSS_KEYS + ("grad_norm",)
_UNPORTED_LAMBDAS = ("lambda_recon_y", "lambda_recon_y_fused", "lambda_kl",
                     "lambda_adv_s")


def metrics_to_dict(vec) -> Dict[str, float]:
    vals = torch.as_tensor(vec).detach().float().cpu().numpy()
    return {k: float(v) for k, v in zip(METRIC_KEYS, vals)}


def draw_pairs(rng: np.random.Generator, modality_num: int, n: int):
    """Host-side random (i, j) pair per microbatch, mirroring the
    reference's numpy RNG use (src/model.py:3485, 3564)."""
    if modality_num == 2:
        return np.tile(np.array([0, 1], np.int32), (n, 1))
    return np.stack([rng.choice(modality_num, 2, replace=False)
                     for _ in range(n)]).astype(np.int32)


def assemble_losses(cfg, batch, out, sim_pair) -> Dict[str, torch.Tensor]:
    """The weighted sum of the shipped loss terms (main_missing.py:192-251).
    Any other nonzero weight raises: those terms are not ported yet."""
    for name in _UNPORTED_LAMBDAS:
        if getattr(cfg, name) > 0:
            raise NotImplementedError(
                f"{name} > 0 is not ported yet (ROADMAP.md, queue 1, "
                "item 13)")
    x, mask = batch["inputs"], batch["mask"]
    grid = out["x_fake_grid"]
    diag = grid.diagonal(0, 0, 1).movedim(-1, 0)          # grid[i, i]
    zero = torch.zeros((), device=x.device)
    l = {k: zero for k in LOSS_KEYS}
    total = zero
    if cfg.lambda_recon_x > 0:
        l["recon_x"] = L.recon_loss_x(x, diag, mask, p=cfg.p)
        total = total + cfg.lambda_recon_x * l["recon_x"]
    if cfg.lambda_recon_x_mix > 0:
        l["recon_x_mix"] = L.recon_loss_x_mix(x, grid, mask, p=cfg.p)
        total = total + cfg.lambda_recon_x_mix * l["recon_x_mix"]
    if cfg.lambda_latent_z > 0:
        l["latent_z"] = L.latent_z_loss(out["z_mean"], out["z_mean_new"],
                                        mask)
        total = total + cfg.lambda_latent_z * l["latent_z"]
    if cfg.lambda_sim_s > 0:
        l["sim_s"] = L.similarity_s_loss(out["s"], mask, sim_pair,
                                         compact_method=cfg.s_compact_method)
        total = total + cfg.lambda_sim_s * l["sim_s"]
    if cfg.lambda_sim_z > 0:
        l["sim_z"] = L.similarity_z_loss(out["z"], mask)
        total = total + cfg.lambda_sim_z * l["sim_z"]
    l["all"] = total
    return l


def prepare_batch(batch, device, cfg) -> Dict[str, torch.Tensor]:
    """One microbatch as tensors on ``device``: inputs [M, B, H, W, Cb] in
    the compute dtype, mask [B, M] and mask_img [B, H, W] in f32."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    return {"inputs": torch.as_tensor(batch["inputs"], device=device,
                                      dtype=torch.float32).to(dtype),
            "mask": torch.as_tensor(batch["mask"], device=device,
                                    dtype=torch.float32),
            "mask_img": torch.as_tensor(batch["mask_img"], device=device,
                                        dtype=torch.float32)}


def loss_fn(model, cfg, batch, generator: Optional[torch.Generator],
            sim_pair, compute_y: bool) -> Dict[str, torch.Tensor]:
    """The train-mode forward of one prepared microbatch and its losses."""
    out = model(batch["inputs"], batch["mask"], batch["mask_img"],
                generator, compute_y=compute_y,
                latent_cycle=cfg.lambda_latent_z > 0)
    return assemble_losses(cfg, batch, out, sim_pair)


def make_train_step(model, cfg, optimizer: torch.optim.Optimizer):
    """Returns ``step(microbatches, generator, sim_pairs, first_of_epoch=
    False) -> metrics``.

    microbatches: dict of inputs [A, M, B, H, W, Cb], mask [A, B, M],
    mask_img [A, B, H, W] (numpy arrays or tensors); generator: the
    torch.Generator on the model's device that ``sample_z`` draws from (None
    takes z = the mean); sim_pairs: [A, 2] modality pairs (``draw_pairs``).
    The learning rate is the optimizer's (``ReduceLROnPlateau.apply`` sets
    it between steps).  metrics: f32 [len(METRIC_KEYS)] on the device."""
    n_micro = max(cfg.effective_batch // cfg.batch_size, 1)
    needs_y = cfg.lambda_recon_y > 0 or cfg.lambda_recon_y_fused > 0
    params = list(model.parameters())
    device = model.device

    def step(microbatches, generator, sim_pairs,
             first_of_epoch: bool = False) -> torch.Tensor:
        model.train()
        for p in params:                 # unreached params get zero grads,
            if p.grad is None:           # and Adam's weight decay, as in JAX
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        loss_sums = torch.zeros(len(LOSS_KEYS), device=device)
        grad_norm = torch.zeros((), device=device)
        for a in range(n_micro):
            mb = prepare_batch({k: v[a] for k, v in microbatches.items()},
                               device, cfg)
            compute_y = needs_y or (first_of_epoch and a == 0)
            l = loss_fn(model, cfg, mb, generator, sim_pairs[a], compute_y)
            l["all"].backward()
            grad_norm = clip_global_norm([p.grad for p in params],
                                         cfg.grad_clip_norm)
            loss_sums += torch.stack([l[k].detach().float()
                                      for k in LOSS_KEYS])
        optimizer.step()
        return torch.cat([loss_sums, grad_norm[None]])

    return step
