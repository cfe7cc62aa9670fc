"""The validation step and loop, with the JAX package's semantics (JAX
training/evaluate.py; reference src/main_missing.py:337-609).

``make_eval_step`` runs the model in eval mode with z = the encoder mean,
the same loss terms as training, and the per-slice metrics on the device:
SSIM/PSNR/MSE of the mix reconstructions while no y-loss is on, else
Dice/IoU (BraTS) or SSIM/PSNR/MSE of the fused y.  The losses come back as
one [11] f32 vector and the metrics as one [n_metrics, n_slices] matrix, so
a batch costs two small host fetches.  Under ``compute_dtype: bfloat16``
the model sees bf16 inputs while the metrics score the uncast f32 inputs.

``evaluate`` runs the loop over an in-memory loader: an iterable of dicts
with ``inputs`` [M, B, H, W, Cb], ``targets`` [B, H, W, Ct], ``mask``
[B, M], ``mask_img`` [B, H, W] (numpy arrays or tensors) and optionally
``valid`` [B] (False on padding rows, whose metrics are dropped).  The
result dump (``save_res``) and the z retrieval modes write and read HDF5
files and are not ported yet (ROADMAP.md queue 1, items 2 and 10).

Example (on the card)::

    eval_steps = make_eval_step(model, cfg)
    stat = evaluate(model, cfg, batches, eval_steps=eval_steps)
    monitor = stat["recon_x_mix"]
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from representation_disentanglement_torch.metrics import (
    recon_metrics_device, seg_metrics_device)
from representation_disentanglement_torch.training.train import (
    LOSS_KEYS, assemble_losses, draw_pairs, prepare_batch)


def parse_retrieval_info(info: str):
    """The eval ``info`` tag -> (retrieval_mode, query_source).

    ``nearest_neighbour`` / ``mean``: the reference's rule (query modality
    |1-i|, src/main_missing.py:416-425).  ``nearest_neighbour_src=<c>`` /
    ``mean_src=<c>``: every missing modality is queried with modality c's
    anatomy.  Anything else: (None, None)."""
    for mode in ("nearest_neighbour", "mean"):
        if info == mode:
            return mode, None
        if info.startswith(mode + "_src="):
            return mode, int(info[len(mode) + 5:])
    return None, None


def mix_metric_mat(inputs, grid):
    """Per-slice (ssim, psnr, mse) of the mix reconstructions, channel 0,
    in the reference's i-major, j != i order (src/main_missing.py:519-527).
    inputs [M, B, H, W, Cb] ground truth; grid [M_i, M_j, B, H, W, Cb]
    -> [3, M(M-1)*B]."""
    M = grid.shape[0]
    pairs = [(i, j) for i in range(M) for j in range(M) if i != j]
    gts = torch.cat([inputs[j, ..., 0] for _, j in pairs], 0)
    preds = torch.cat([grid[i, j, ..., 0] for i, j in pairs], 0)
    return torch.stack(recon_metrics_device(gts, preds))


def make_eval_step(model, cfg):
    """Returns ``(eval_step, decode_with_z, metric_names)``.

    ``eval_step(batch, sim_pair, adv_pair=None, compute_y=True)`` -> (out,
    loss_vec [11] f32, metric_mat [n_metrics, n_slices] f32), both on the
    model's device; ``out`` is the forward's dict.  With the s
    discriminator the forward scores ``adv_pair`` and the adversarial terms
    join the losses (JAX evaluate.py:105-113).  ``decode_with_z(s, z)``
    re-decodes the grid from anatomy codes [M, B, H, W, Cs] and z
    [M, B, z]."""
    needs_y = cfg.lambda_recon_y > 0 or cfg.lambda_recon_y_fused > 0
    device = model.device
    if not needs_y:
        metric_names = ("ssim", "psnr", "rmse")          # on the mix recon
    elif cfg.dataset_name == "BraTS":
        metric_names = ("dice", "iou")                   # on the fused y
    else:
        metric_names = ("ssim", "psnr", "rmse")          # on the fused y

    def device_metrics(inputs, targets, out):
        if not needs_y:
            return mix_metric_mat(inputs, out["x_fake_grid"])
        yf = out["y_fake_fused"]
        tgt = targets[..., 0]
        if cfg.dataset_name == "BraTS":
            # channel i+1 of the logits is class i+1 (JAX evaluate.py:96-98)
            return torch.stack(seg_metrics_device(tgt, yf[..., 1:]))
        return torch.stack(recon_metrics_device(tgt, yf[..., 0]))

    def eval_step(batch, sim_pair, adv_pair=None, compute_y: bool = True):
        model.eval()
        with torch.no_grad():
            inputs = torch.as_tensor(batch["inputs"], device=device,
                                     dtype=torch.float32)
            cb = prepare_batch(dict(batch, inputs=inputs), device, cfg)
            adv = adv_pair if cfg.is_discrim_s else None
            out = model(cb["inputs"], cb["mask"], cb["mask_img"], None,
                        compute_y=compute_y or needs_y,
                        latent_cycle=cfg.lambda_latent_z > 0, adv_pair=adv)
            l = assemble_losses(cfg, cb, out, sim_pair, adv)
            loss_vec = torch.stack([l[k].float() for k in LOSS_KEYS])
            targets = torch.as_tensor(batch["targets"], device=device,
                                      dtype=torch.float32)
            return out, loss_vec, device_metrics(inputs, targets, out)

    def decode_with_z(s, z_find):
        """Re-decode with retrieved z (src/main_missing.py:427-428)."""
        model.eval()
        with torch.no_grad():
            return model.decode_inputs_grid(s, z_find)

    return eval_step, decode_with_z, metric_names


def evaluate(model, cfg, loader, *, save_res: bool = False, info: str = "",
             sim_rng: Optional[np.random.Generator] = None,
             eval_steps=None) -> Dict[str, float]:
    """The validation loop: per batch one eval step (the y decodes at the
    first batch only), a sim pair and an adversarial pair drawn from
    ``sim_rng`` (default ``default_rng(10)``), loss sums and the per-slice
    metrics of the ``valid`` rows; it stops after batch ``eval_max_iters``
    (src/main_missing.py:561).  Returns the mean of each loss term over the
    batches and the mean of each metric over the slices."""
    if save_res or parse_retrieval_info(info)[0] is not None:
        raise NotImplementedError(
            "the result dump and the z retrieval read and write HDF5; not "
            "ported yet (ROADMAP.md, queue 1, items 2 and 10)")
    eval_step, _, metric_names = eval_steps or make_eval_step(model, cfg)
    sim_rng = sim_rng or np.random.default_rng(10)
    M = cfg.modality_num
    loss_sums = np.zeros(len(LOSS_KEYS), np.float64)
    metrics_acc: Dict[str, list] = {}
    n_iter = 0
    for it, batch in enumerate(loader):
        sim_pair = draw_pairs(sim_rng, M, 1)[0]
        adv_pair = draw_pairs(sim_rng, M, 1)[0]
        _, loss_vec, metric_mat = eval_step(batch, sim_pair, adv_pair,
                                            compute_y=(it == 0))
        loss_sums += torch.as_tensor(loss_vec).cpu().numpy().astype(
            np.float64)
        mat = torch.as_tensor(metric_mat).float().cpu().numpy()
        if "valid" in batch:
            valid = np.asarray(batch["valid"]).astype(bool)
            reps = mat.shape[1] // valid.shape[0]   # 1 (y) or M(M-1) (mix)
            mat = mat[:, np.tile(valid, reps)]
        for k, row in zip(metric_names, mat):
            metrics_acc.setdefault(k, []).extend(row.astype(float).tolist())
        n_iter = it + 1
        if it > cfg.eval_max_iters - 1:
            break
    stat = {k: float(v) / max(n_iter, 1)
            for k, v in zip(LOSS_KEYS, loss_sums)}
    for k, v in metrics_acc.items():
        stat[k] = float(np.mean(v))
    return stat
