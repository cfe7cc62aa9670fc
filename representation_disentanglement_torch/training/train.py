"""The training step, with the JAX package's semantics (JAX
training/train.py:72-134, 192-293; reference src/main_missing.py:141-335).

One call of the step consumes A = effective_batch // batch_size
microbatches stacked on a leading axis:

    for a in range(A):  g_acc = clip(g_acc + grad(microbatch a))
    params <- Adam(amsgrad)(g_acc)
    [adversarial] params <- Adam_D(d_grads of the last microbatch)

The reference clips the *accumulated* gradient after every microbatch
(main_missing.py:272).  BatchNorm running statistics thread through the
microbatches in order.  ``compute_y`` follows the reference's "decode y
only at iteration 0 unless a y-loss is on" rule (main_missing.py:182-190);
with the shipped losses it only decides which BN statistics move.

With the s discriminator (``lambda_adv_s > 0``) the step also takes the
discriminator's Adam step (JAX train.py:216-282): the gradient of the
discriminator loss with respect to every parameter (quirk Q3), from the
last microbatch at the pre-step parameters, applied after the main step.
It stays in ``.grad`` and starts the next step's accumulation (quirk Q10,
reference main_missing.py:286-289); nothing else zeroes it, and a new
model starts from zero, as the JAX package's resume does.  The
discriminator's forward is the one in the last microbatch's train forward:
its logits depend only on s, which a second forward would recompute
equal, so no running statistic moves twice.

The VGG similarity paths read the frozen VGG16 weights of ``cfg.vgg_npz``
(``load_vgg_constants``, once per path and device) and the model's
``vgg_pre``, which is not a stage-1 module: it trains under the freeze.

With the stage-2 freeze (``continue_train`` + ``fix_pretrain``, reference
main_missing.py:104-116; JAX train.py:171-189) ``make_train_step`` turns
off ``requires_grad`` of the stage-1 modules (``STAGE1_PREFIXES``), so
autograd runs no backward through them (the JAX package replaces their
gradients with zeros inside its jitted step).  Their gradients stay zero,
so they stay out of the clip norm, and their Adam updates are masked: they
end each step bit-identical, while their Adam moments evolve from the
weight decay as JAX's do.  Their BatchNorm running statistics still move
(the modules stay in train mode).

Under ``compute_dtype: bfloat16`` the inputs are cast to bf16 once per
microbatch; parameters, optimizer state, BN statistics and the loss sums
stay f32.  The step returns the metrics as one stacked f32 tensor on the
device, in the order ``METRIC_KEYS``; ``metrics_to_dict`` reads it with one
host sync.

Data parallelism (``mesh``, a ``parallel.mesh.Axis``; JAX parallel/mesh.py):
each rank passes its rows of every microbatch ([A, M, B/N, ...]) and runs
the forward inside ``data_parallel(mesh)``, where the losses are the global
batch's, BatchNorm is synchronized and z's noise is the unsharded step's
(parallel/mesh.py).  Each microbatch's gradient is averaged over the ranks
before it joins the accumulated gradient and its clip, the
discriminator's too, so every rank takes the same Adam steps from the same
gradients and ends the step with the unsharded step's parameters,
statistics and metrics (up to the order of reductions).

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

import functools
from typing import Dict, Optional

import numpy as np
import torch

from representation_disentanglement_torch import losses as L
from representation_disentanglement_torch.models.vgg import (
    load_vgg_npz, vgg_constants)
from representation_disentanglement_torch.parallel.mesh import (
    all_reduce_grads, data_parallel)
from representation_disentanglement_torch.training.optim import (
    clip_global_norm)
from representation_disentanglement_torch.utils.profiling import span

LOSS_KEYS = ("recon_y", "recon_y_fused", "recon_x", "recon_x_mix", "kl",
             "latent_z", "sim_s", "sim_z", "adv_s", "adv_s_d", "all")
METRIC_KEYS = LOSS_KEYS + ("grad_norm",)
# the stage-1 modules that the stage-2 freeze holds
STAGE1_PREFIXES = ("anatomy_encoder_enc_list.", "anatomy_encoder_dec.",
                   "modality_encoder_list.", "input_decoder_list.")


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


def is_stage1_param(name: str) -> bool:
    """The stage-1 modules that the stage-2 freeze holds (the port's
    counterparts of JAX train.py:171-179 ``STAGE1_ROOTS``)."""
    return name.startswith(STAGE1_PREFIXES)


@functools.lru_cache(maxsize=2)
def _vgg_constants_cached(npz_path: str, device: str):
    return vgg_constants(load_vgg_npz(npz_path), device)


def load_vgg_constants(cfg, device):
    """The frozen VGG16 weights of the perceptual / vgg-compact paths
    (JAX train.py:44-59) as f32 tensors on ``device``, or None when the
    config does not use them.  Loaded once per (path, device) and shared by
    the train, eval and retrieval steps; they are no parameters and reach
    neither the checkpoint nor the optimizer."""
    if cfg.s_sim_method != "perceptual" and cfg.s_compact_method != "vgg":
        return None
    return _vgg_constants_cached(cfg.vgg_npz, str(torch.device(device)))


def make_vgg_ctx(model, cfg):
    """The trained ``vgg_pre`` projection (the model's parameters, live)
    with ``cfg``'s frozen VGG16 weights on the model's device, for the
    losses (JAX train.py:62-69); None when the config does not use them."""
    consts = load_vgg_constants(cfg, model.device)
    if consts is None:
        return None
    return {"pre_weight": model.vgg_pre.weight,
            "pre_bias": model.vgg_pre.bias, "vgg_params": consts}


def assemble_losses(cfg, batch, out, sim_pair, adv_pair=None, vgg_ctx=None
                    ) -> Dict[str, torch.Tensor]:
    """The weighted loss (main_missing.py:192-251), in JAX train.py:72-134's
    order.  The y losses are the segmentation loss for BraTS and the L``p``
    reconstruction otherwise; the KL is to the learned prior with
    ``is_distri_z``, else to N(0, I); the adversarial terms need the
    forward's ``d_logits`` for ``adv_pair``; the VGG similarity paths need
    ``vgg_ctx`` (``make_vgg_ctx``)."""
    x, mask = batch["inputs"], batch["mask"]
    targets = batch.get("targets")
    grid = out["x_fake_grid"]
    zero = torch.zeros((), device=x.device)
    l = {k: zero for k in LOSS_KEYS}
    total = zero
    seg = cfg.dataset_name == "BraTS"
    if cfg.lambda_recon_y > 0:
        l["recon_y"] = (
            L.segmentation_loss_y_list(targets, out["y_fake_list"], mask)
            if seg else L.recon_loss_y_list(targets, out["y_fake_list"],
                                            mask, p=cfg.p))
        total = total + cfg.lambda_recon_y * l["recon_y"]
    if cfg.lambda_recon_y_fused > 0:
        l["recon_y_fused"] = (
            L.segmentation_loss_y(targets, out["y_fake_fused"]) if seg
            else L.recon_loss_y(targets, out["y_fake_fused"], p=cfg.p))
        total = total + cfg.lambda_recon_y_fused * l["recon_y_fused"]
    if cfg.lambda_recon_x > 0:
        diag = grid.diagonal(0, 0, 1).movedim(-1, 0)      # grid[i, i]
        l["recon_x"] = L.recon_loss_x(x, diag, mask, p=cfg.p)
        total = total + cfg.lambda_recon_x * l["recon_x"]
    if cfg.lambda_recon_x_mix > 0:
        l["recon_x_mix"] = L.recon_loss_x_mix(x, grid, mask, p=cfg.p)
        total = total + cfg.lambda_recon_x_mix * l["recon_x_mix"]
    if cfg.lambda_kl > 0:
        if cfg.is_distri_z:
            pm, pv = out["z_prior"]
            l["kl"] = L.kl_loss_two_gaussian_list(
                out["z_mean"], out["z_log_var"], pm, pv, mask)
        else:
            l["kl"] = L.kl_loss_standard_list(out["z_mean"],
                                              out["z_log_var"], mask)
        total = total + cfg.lambda_kl * l["kl"]
    if cfg.lambda_latent_z > 0:
        l["latent_z"] = L.latent_z_loss(out["z_mean"], out["z_mean_new"],
                                        mask)
        total = total + cfg.lambda_latent_z * l["latent_z"]
    if cfg.lambda_sim_s > 0:
        l["sim_s"] = L.similarity_s_loss(
            out["s"], mask, sim_pair, compact_method=cfg.s_compact_method,
            sim_method=cfg.s_sim_method, vgg_ctx=vgg_ctx)
        total = total + cfg.lambda_sim_s * l["sim_s"]
    if cfg.lambda_sim_z > 0:
        l["sim_z"] = L.similarity_z_loss(out["z"], mask)
        total = total + cfg.lambda_sim_z * l["sim_z"]
    if cfg.lambda_adv_s > 0:
        mask_pair = mask[:, [int(a) for a in adv_pair]].t()    # [2, B]
        l["adv_s_d"], l["adv_s"] = L.adversarial_loss(out["d_logits"],
                                                      mask_pair)
        total = total + cfg.lambda_adv_s * l["adv_s"]
    l["all"] = total
    return l


def prepare_batch(batch, device, cfg) -> Dict[str, torch.Tensor]:
    """One microbatch as tensors on ``device``: inputs [M, B, H, W, Cb] in
    the compute dtype; mask [B, M], mask_img [B, H, W] and, when given,
    targets [B, H, W, Ct] in f32."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    out = {"inputs": torch.as_tensor(batch["inputs"], device=device,
                                     dtype=torch.float32).to(dtype)}
    for k in ("mask", "mask_img", "targets"):
        if k in batch:
            out[k] = torch.as_tensor(batch[k], device=device,
                                     dtype=torch.float32)
    return out


def loss_fn(model, cfg, batch, generator: Optional[torch.Generator],
            sim_pair, compute_y: bool, adv_pair=None, vgg_ctx=None
            ) -> Dict[str, torch.Tensor]:
    """The train-mode forward of one prepared microbatch and its losses;
    ``adv_pair`` is None unless the model has the discriminator;
    ``vgg_ctx`` defaults to ``make_vgg_ctx(model, cfg)``."""
    out = model(batch["inputs"], batch["mask"], batch["mask_img"],
                generator, compute_y=compute_y,
                latent_cycle=cfg.lambda_latent_z > 0, adv_pair=adv_pair)
    if vgg_ctx is None:
        vgg_ctx = make_vgg_ctx(model, cfg)
    return assemble_losses(cfg, batch, out, sim_pair, adv_pair, vgg_ctx)


def make_train_step(model, cfg, optimizer: torch.optim.Optimizer,
                    d_optimizer: Optional[torch.optim.Optimizer] = None,
                    mesh=None):
    """Returns ``step(microbatches, generator, sim_pairs, adv_pairs=None,
    first_of_epoch=False) -> metrics``.

    microbatches: dict of inputs [A, M, B, H, W, Cb], mask [A, B, M],
    mask_img [A, B, H, W] and, for the y losses, targets [A, B, H, W, Ct]
    (numpy arrays or tensors); generator: the torch.Generator on the
    model's device that ``sample_z`` draws from (None takes z = the mean);
    sim_pairs, adv_pairs: [A, 2] modality pairs (``draw_pairs``), the
    second needed with the discriminator, whose Adam (``optim.
    make_d_optimizer``) is ``d_optimizer``.  The learning rates are the
    optimizers' (``ReduceLROnPlateau.apply`` sets them between steps).
    metrics: f32 [len(METRIC_KEYS)] on the device.  With a data ``mesh``
    the microbatches are the rank's rows (module docstring)."""
    n_micro = max(cfg.effective_batch // cfg.batch_size, 1)
    needs_y = cfg.lambda_recon_y > 0 or cfg.lambda_recon_y_fused > 0
    adv = cfg.is_discrim_s
    if adv and d_optimizer is None:
        raise ValueError("lambda_adv_s > 0 needs the discriminator's "
                         "optimizer (optim.make_d_optimizer)")
    named = list(model.named_parameters())
    params = [p for _, p in named]
    frozen = [p for n, p in named if is_stage1_param(n)] \
        if cfg.fix_pretrain and cfg.continue_train else []
    for p in frozen:        # no backward through them; their .grad stays 0
        p.requires_grad_(False)
    trained = [p for p in params if p.requires_grad]
    device = model.device
    vgg_ctx = make_vgg_ctx(model, cfg)

    def step(microbatches, generator, sim_pairs, adv_pairs=None,
             first_of_epoch: bool = False) -> torch.Tensor:
        if adv and adv_pairs is None:
            raise ValueError("lambda_adv_s > 0 needs adv_pairs")
        with span("rdt.train.step"):
            model.train()
            for p in params:             # unreached params get zero grads,
                if p.grad is None:       # and Adam's weight decay, as in JAX
                    p.grad = torch.zeros_like(p)
                elif not adv:            # the adversarial carry stays
                    p.grad.zero_()
            loss_sums = torch.zeros(len(LOSS_KEYS), device=device)
            grad_norm = torch.zeros((), device=device)
            for a in range(n_micro):
                with data_parallel(mesh), span("rdt.step.forward"):
                    mb = prepare_batch({k: v[a]
                                        for k, v in microbatches.items()},
                                       device, cfg)
                    compute_y = needs_y or (first_of_epoch and a == 0)
                    l = loss_fn(model, cfg, mb, generator, sim_pairs[a],
                                compute_y, adv_pairs[a] if adv else None,
                                vgg_ctx)
                with data_parallel(mesh), span("rdt.step.backward"):
                    if adv and a == n_micro - 1:
                        d_grads = torch.autograd.grad(l["adv_s_d"], trained,
                                                      retain_graph=True,
                                                      allow_unused=True)
                        all_reduce_grads(d_grads, mesh)
                    if mesh is None:
                        l["all"].backward()
                    else:
                        grads = torch.autograd.grad(l["all"], trained,
                                                    allow_unused=True)
                        all_reduce_grads(grads, mesh)
                        with torch.no_grad():
                            for p, g in zip(trained, grads):
                                if g is not None:
                                    p.grad.add_(g)
                    grad_norm = clip_global_norm([p.grad for p in trained],
                                                 cfg.grad_clip_norm)
                loss_sums += torch.stack([l[k].detach().float()
                                          for k in LOSS_KEYS])
            with span("rdt.step.optimizer"):
                with torch.no_grad():
                    kept = [p.clone() for p in frozen]
                optimizer.step()
                if adv:
                    with torch.no_grad():
                        for p, g in zip(trained, d_grads):
                            if g is None:
                                p.grad.zero_()
                            else:
                                p.grad.copy_(g)
                    d_optimizer.step()
                with torch.no_grad():
                    for p, v in zip(frozen, kept):
                        p.copy_(v)
            return torch.cat([loss_sums, grad_norm[None]])

    return step
