"""The train and eval steps of the whole-volume 3D path, NVNet3D (JAX
``training/train3d.py``).

The reference ships the NVNet3D modules and the 3D datasets but no script
(SURVEY §2.6); the recipe is the standard Myronenko one: soft-Dice
segmentation + VAE L2 reconstruction + KL (``models.unet3d.nvnet_loss``),
the gradient clipped to a global norm of 1, one Adam(amsgrad) step with the
weight decay as L2, as the 2D path's ``training/optim.py``.

``make_sharded_train_step_3d`` is the depth-sharded step (JAX
``make_sharded_train_step_3d``, train3d.py:93-169), depth-only or composed
with a data axis (``parallel.halo.make_volume_mesh``).  ``train_loop_3d``
is the per-step loop of ``main_3d``'s epochs (and of the benchmark): load,
copy to the card, step, read the metrics back.

Spans (``utils/profiling.span``): both steps open ``rdt.train.step``
with ``rdt.step.forward`` (forward and loss), ``rdt.step.backward``
(backward; after the last microbatch the all-reduce and the clip) and
``rdt.step.optimizer`` (Adam) inside; ``train_loop_3d`` opens
``rdt.load3d`` around each step's sampling, collation and copy to the
card, outside the step's span.
"""

from __future__ import annotations

from itertools import islice
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from representation_disentanglement_torch.models.unet3d import (
    NVNet3D, nvnet_loss)
from representation_disentanglement_torch.ops.conv3d import depth_sharded
from representation_disentanglement_torch.parallel.mesh import (
    all_reduce_grads, data_parallel, local_rows)
from representation_disentanglement_torch.training.optim import (
    clip_global_norm)
from representation_disentanglement_torch.utils.profiling import span

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
        with span("rdt.train.step"):
            model.train()
            xs, ts = batch["inputs"], batch["targets"]
            if accum == 1:
                xs, ts = xs[None], ts[None]
            opt.zero_grad(set_to_none=True)
            sums = None
            for a in range(accum):
                with span("rdt.step.forward"):
                    uout, vout, mu, logvar = model(xs[a], generator)
                    loss, aux = nvnet_loss(uout, vout, mu, logvar, ts[a],
                                           xs[a], kl_weight, recon_weight)
                with span("rdt.step.backward"):
                    (loss / accum).backward()
                    if a == accum - 1:
                        gnorm = clip_global_norm([p.grad for p in params],
                                                 clip_norm)
                terms = torch.stack([loss, aux["dice_loss"],
                                     aux["vae_recon"], aux["kl"]]).detach()
                sums = terms if sums is None else sums + terms
            with span("rdt.step.optimizer"):
                opt.step()
            means = sums / accum
            return {"loss": means[0], "grad_norm": gnorm,
                    "dice_loss": means[1], "vae_recon": means[2],
                    "kl": means[3]}

    return step


def make_sharded_train_step_3d(model: NVNet3D, opt: torch.optim.Adam,
                               mesh, clip_norm: float = 1.0,
                               kl_weight: float = 0.1,
                               recon_weight: float = 0.1):
    """The train step with each volume's depth (the last dim) split over
    ``mesh.depth`` and, for a composed mesh, the batch over ``mesh.data``
    (a ``parallel.halo.VolumeMesh``).  ``step(batch, generator=None)``
    takes the GLOBAL batch (``inputs`` [B, M, H, W, D], ``targets``
    [B, 1, H, W, D], the same on every rank) and returns
    ``make_train_step_3d``'s metrics, the global batch's.

    Each rank runs the model on its block inside the ``depth_sharded`` (and
    ``data_parallel``) scopes: halo-exchange convolutions, all-reduced
    GroupNorm statistics and pooling, the Dice sums, reconstruction and KL
    reduced over both axes inside ``nvnet_loss``, so every rank holds the
    unsharded step's loss.  The transposes of those reductions sum the
    ranks' cotangents, so each rank's gradient is the world size times its
    share: their mean over all ranks is the total gradient (JAX's pmean
    over both axes), clipped and applied by the same Adam step everywhere.
    Noise is drawn at the global shape and cut to the block (the
    generators must be seeded alike): the sharded step draws the unsharded
    step's dropout masks and eps, so rows on different data ranks get
    distinct noise, as JAX's fold-in of the row index gives them."""
    params = list(model.parameters())

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        with span("rdt.train.step"):
            model.train()
            xs, ts = batch["inputs"], batch["targets"]
            if mesh.data is not None:
                xs, ts = local_rows(xs, 0, mesh.data), local_rows(
                    ts, 0, mesh.data)
            xs, ts = local_rows(xs, 4, mesh.depth), local_rows(ts, 4,
                                                               mesh.depth)
            opt.zero_grad(set_to_none=True)
            with depth_sharded(mesh.depth), data_parallel(mesh.data), \
                    span("rdt.step.forward"):
                uout, vout, mu, logvar = model(xs, generator)
                loss, aux = nvnet_loss(uout, vout, mu, logvar, ts, xs,
                                       kl_weight, recon_weight)
            with span("rdt.step.backward"):
                loss.backward()
                grads = [p.grad for p in params]
                all_reduce_grads(grads, mesh.world)
                gnorm = clip_global_norm(grads, clip_norm)
            with span("rdt.step.optimizer"):
                opt.step()
            return {"loss": loss.detach(), "grad_norm": gnorm,
                    "dice_loss": aux["dice_loss"].detach(),
                    "vae_recon": aux["vae_recon"].detach(),
                    "kl": aux["kl"].detach()}

    return step


def train_loop_3d(step, batches: Iterable[dict], accum: int, device,
                  generator: Optional[torch.Generator] = None,
                  epoch: int = 0) -> Iterator[Dict[str, float]]:
    """Drive ``step`` (``make_train_step_3d``'s or the sharded one) over
    ``batches`` (host batches of ``main_3d.volume_loader``: ``inputs``
    [B, M, H, W, D], ``targets`` [B, 1, H, W, D]) and yield each optimizer
    step's metrics as host floats (``METRIC_KEYS``).

    Per step: ``accum`` batches drawn and copied to ``device`` (stacked
    on a leading microbatch axis when ``accum > 1``) inside the
    ``rdt.load3d`` span, the step, then its one device-to-host copy of the
    metrics; a non-finite one raises FloatingPointError (``epoch`` names
    it).  When ``batches`` ends with fewer than ``accum`` left, they are
    dropped and said so."""
    it = iter(batches)
    n = 0
    while True:
        with span("rdt.load3d"):
            micro = list(islice(it, accum))
            if len(micro) < accum:
                break
            stack = lambda k: torch.as_tensor(
                micro[0][k] if accum == 1
                else np.stack([m[k] for m in micro]), device=device)
            batch = {"inputs": stack("inputs"), "targets": stack("targets")}
        m = step(batch, generator)
        # one device-to-host copy per step
        mvals = torch.stack([m[k] for k in METRIC_KEYS]).cpu().numpy()
        if not np.isfinite(mvals).all():
            raise FloatingPointError(
                f"non-finite metric at epoch {epoch} step {n}: "
                f"{dict(zip(METRIC_KEYS, map(float, mvals)))}")
        n += 1
        yield dict(zip(METRIC_KEYS, map(float, mvals)))
    if micro:
        print(f"[accum] dropping {len(micro)} leftover microbatch(es) "
              "at epoch end (epoch yielded a non-multiple of --accum)")


def make_eval_step_3d(model: NVNet3D):
    """``step(inputs)`` -> (sigmoid(uout), vout), eval mode, no autograd."""

    @torch.no_grad()
    def step(inputs: torch.Tensor):
        model.eval()
        uout, vout, _, _ = model(inputs)
        return torch.sigmoid(uout), vout

    return step
