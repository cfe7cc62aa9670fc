"""The train and eval steps of the whole-volume 3D path, NVNet3D (JAX
``training/train3d.py``).

The reference ships the NVNet3D modules and the 3D datasets but no script
(SURVEY §2.6); the recipe is the standard Myronenko one: soft-Dice
segmentation + VAE L2 reconstruction + KL (``models.unet3d.nvnet_loss``),
the gradient clipped to a global norm of 1, one Adam(amsgrad) step with the
weight decay as L2, as the 2D path's ``training/optim.py``.

The depth-sharded step (JAX ``make_sharded_train_step_3d``) is ROADMAP
item 16.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from representation_disentanglement_torch.models.unet3d import (
    NVNet3D, nvnet_loss)
from representation_disentanglement_torch.training.optim import (
    clip_global_norm)

METRIC_KEYS = ("loss", "grad_norm", "dice_loss", "vae_recon", "kl")


def create_state_3d(model: NVNet3D, weight_decay: float = 1e-5,
                    lr: float = 1e-4) -> torch.optim.Adam:
    """The optimizer of ``model``: torch Adam(amsgrad), betas (0.9, 0.999),
    eps 1e-8, ``weight_decay`` added to the gradient (what the JAX
    package's ``adam_amsgrad_torch`` reproduces).  Its state holds the step
    count; the model holds the parameters."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay,
                            amsgrad=True)


def make_train_step_3d(model: NVNet3D, opt: torch.optim.Adam,
                       clip_norm: float = 1.0, kl_weight: float = 0.1,
                       recon_weight: float = 0.1, accum: int = 1):
    """``step(batch, generator=None)`` -> {metric: 0-d f32 tensor on the
    device} (``METRIC_KEYS``), nothing read back to the host.

    ``batch`` has ``inputs`` [B, M, H, W, D] and ``targets`` [B, 1, H, W,
    D] on the model's device; with ``accum > 1`` a leading microbatch axis
    [A, ...], and the gradients average over the A microbatches before one
    clip and one Adam step (volumes are large: effective batch grows
    without memory).  The loss and its terms are then the microbatches'
    means.  ``generator`` draws the dropout masks and the VAE's eps; None
    trains deterministically (z = mu, no dropout)."""
    params = list(model.parameters())

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        model.train()
        xs, ts = batch["inputs"], batch["targets"]
        if accum == 1:
            xs, ts = xs[None], ts[None]
        opt.zero_grad(set_to_none=True)
        sums = None
        for a in range(accum):
            uout, vout, mu, logvar = model(xs[a], generator)
            loss, aux = nvnet_loss(uout, vout, mu, logvar, ts[a], xs[a],
                                   kl_weight, recon_weight)
            (loss / accum).backward()
            terms = torch.stack([loss, aux["dice_loss"], aux["vae_recon"],
                                 aux["kl"]]).detach()
            sums = terms if sums is None else sums + terms
        gnorm = clip_global_norm([p.grad for p in params], clip_norm)
        opt.step()
        means = sums / accum
        return {"loss": means[0], "grad_norm": gnorm,
                "dice_loss": means[1], "vae_recon": means[2],
                "kl": means[3]}

    return step


def make_eval_step_3d(model: NVNet3D):
    """``step(inputs)`` -> (sigmoid(uout), vout), eval mode, no autograd."""

    @torch.no_grad()
    def step(inputs: torch.Tensor):
        model.eval()
        uout, vout, _, _ = model(inputs)
        return torch.sigmoid(uout), vout

    return step
