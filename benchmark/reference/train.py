"""Plain float32 reference of the losses, the clip and Adam (amsgrad, L2)
of one training step (reference src/main_missing.py:141-335 and
src/model.py:3260-3557), and of the block gather from the volume cache.

Mask semantics: a modality's term counts only when its mask column has a
present sample, masked means divide by the mask sum, and the outer
average divides by the number of terms that count (0 when none does).
The reconstruction losses use the norm ``p`` of the configuration.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.model import Reference


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def gather(vols, tgts, presence, rows, slices, drop, block_size: int,
           ref_modality=None):
    """One batch from the cache tensors (vols [S, M, D, H, W], tgts
    [S, D, H, W], presence [S, M]) by plain indexing: rows, slices [B]
    host integers, drop [B, M] host 0/1.  Returns f32 inputs
    [M, B, H, W, 2b+1] (an absent or dropped modality zero-filled),
    targets [B, H, W, 1], mask [B, M] and mask_img [B, H, W], the
    background of modality ``ref_modality`` (0 by default)."""
    dev = vols.device
    blocks = [vols[r, :, s - block_size:s + block_size + 1]
              for r, s in zip(rows, slices)]             # each [M, bc, H, W]
    x = torch.stack(blocks).float().permute(1, 0, 3, 4, 2)  # [M, B, H, W, bc]
    drop = torch.as_tensor(drop, dtype=torch.float32, device=dev)
    mask = presence[list(rows)].float() * drop
    x = x * mask.t()[:, :, None, None, None]
    targets = torch.stack([tgts[r, s] for r, s in zip(rows, slices)])[
        ..., None].float()
    k = 0 if ref_modality is None else ref_modality
    mask_img = (x[k, :, :, :, 0] == 0).float()
    return {"inputs": x, "targets": targets, "mask": mask,
            "mask_img": mask_img}


def _safe_div(num, den):
    return torch.where(den > 0, num / torch.where(den > 0, den,
                                                  torch.ones_like(den)),
                       torch.zeros_like(num))


def _recon(gt, out, p):
    d = gt - out
    return (d.abs() if p == 1 else d.square()).mean(dim=(-3, -2, -1))


def _masked_mean_over_present(r, m):
    """r, m: [M, B] -> mean over the modalities present in the batch of
    each modality's masked mean."""
    msum = m.sum(1)
    per_mod = _safe_div((m * r).sum(1), msum)
    present = (msum > 0).float()
    return _safe_div((per_mod * present).sum(), present.sum())


def _cosine(x, y):
    xn = torch.clamp_min(torch.sqrt(x.square().sum(-1) + 1e-8), 1e-8)
    yn = torch.clamp_min(torch.sqrt(y.square().sum(-1) + 1e-8), 1e-8)
    return (x * y).sum(-1) / (xn * yn)


def _roll(a):
    return torch.cat([a[1:], a[:1]])


def losses(cfg: dict, batch, out, sim_pair) -> Dict[str, torch.Tensor]:
    """The weighted loss of one microbatch and its terms."""
    x, mask, p = batch["inputs"], batch["mask"], cfg["p"]
    m = mask.t()
    grid = out["x_fake_grid"]
    M = x.shape[0]
    zero = torch.zeros((), device=x.device)
    l = {}
    if cfg["lambda_recon_y"] > 0:
        r = _recon(batch["targets"][None], out["y_fake_list"], p)
        l["recon_y"] = _masked_mean_over_present(r, m)
    if cfg["lambda_recon_y_fused"] > 0:
        l["recon_y_fused"] = _recon(batch["targets"], out["y_fake_fused"],
                                    p).mean()
    if cfg["lambda_recon_x"] > 0:
        diag = torch.stack([grid[i, i] for i in range(M)])
        l["recon_x"] = _masked_mean_over_present(_recon(x, diag, p), m)
    if cfg["lambda_recon_x_mix"] > 0:
        r = _recon(x[None], grid, p)                          # [Mi, Mj, B]
        off = (1.0 - torch.eye(M, device=x.device))[:, :, None]
        mm = m[:, None, :] * m[None, :, :] * off
        per_pair = _safe_div((mm * r).sum(2), mm.sum(2))
        counted = (mm.sum(2) > 0).float()
        l["recon_x_mix"] = _safe_div((per_pair * counted).sum(),
                                     counted.sum())
    if cfg["lambda_latent_z"] > 0:
        diff = (out["z_mean"] - out["z_mean_new"]).abs().sum(-1)  # [M, B]
        l["latent_z"] = _masked_mean_over_present(diff, m)
    if cfg["lambda_sim_s"] > 0:
        i, j = int(sim_pair[0]), int(sim_pair[1])
        s = out["s"]

        def compact(v):                                   # [B, H, W, Cs]
            return F.max_pool2d(v.permute(0, 3, 1, 2), 16).flatten(1)
        si, sj = compact(s[i]), compact(s[j])
        mix = m[i] * m[j] * _roll(m[i])
        hinge = torch.clamp_min(0.1 - _cosine(si, sj)
                                + _cosine(_roll(si), si), 0.0)
        l["sim_s"] = _safe_div((mix * hinge).sum(), mix.sum())
    if cfg["lambda_sim_z"] > 0:
        z = out["z"]
        total, count = zero, zero
        for i in range(M - 1):
            cos_mix = _cosine(z[i], _roll(z[i]))
            for j in range(i + 1, M):
                mm = m[i] * m[j] * _roll(m[i])
                hinge = torch.clamp_min(0.1 - cos_mix + _cosine(z[i], z[j]),
                                        0.0)
                has = (mm.sum() > 0).float()
                total = total + _safe_div((mm * hinge).sum(), mm.sum()) * has
                count = count + has
        l["sim_z"] = _safe_div(total, count)
    l["all"] = sum((cfg[f"lambda_{k}"] * v for k, v in l.items()), zero)
    return l


def adam_amsgrad(params: List[torch.Tensor], grads: List[torch.Tensor],
                 state: dict, lr: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8) -> List[torch.Tensor]:
    """One Adam step with amsgrad and L2 weight decay added to the
    gradient, in place on ``params``; returns the gradients as the update
    reads them (clipped gradient + wd * param)."""
    b1, b2 = betas
    state["t"] = t = state.get("t", 0) + 1
    seen = []
    with torch.no_grad():
        for k, (p, g) in enumerate(zip(params, grads)):
            g = g + wd * p
            seen.append(g)
            m = state.setdefault(("m", k), torch.zeros_like(p))
            v = state.setdefault(("v", k), torch.zeros_like(p))
            vmax = state.setdefault(("vmax", k), torch.zeros_like(p))
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            torch.maximum(vmax, v, out=vmax)
            denom = vmax.sqrt() / (1 - b2 ** t) ** 0.5 + eps
            p.sub_(lr / (1 - b1 ** t) * m / denom)
    return seen


def train_steps(model: Reference, cfg: dict, steps: Sequence[dict],
                params: List[torch.Tensor]) -> dict:
    """Run optimizer steps on ``model`` (train mode; its parameters are
    ``params``, in the benchmark's leaf order).  Each step is a dict of
    ``micro`` (the microbatches, each a ``gather`` dict), ``eps`` (one
    [M, b, z] noise per microbatch) and ``sim`` ([A, 2] pairs); y is
    decoded where a loss reads it.  Per microbatch the gradient is added
    to the sum and the sum clipped to global norm ``grad_clip_norm``
    (scale min(1, max / (norm + 1e-6))); then one Adam step.  Returns the
    per-step losses and loss terms and, after the first step, the
    gradients the update read."""
    model.train()
    state, out = {}, {"loss": [], "terms": [], "grad1": None}
    clip = cfg.get("grad_clip_norm", 1.0)
    needs_y = cfg["lambda_recon_y"] > 0 or cfg["lambda_recon_y_fused"] > 0
    for st in steps:
        acc = [torch.zeros_like(p) for p in params]
        loss_sum, terms = 0.0, {}
        for a, mb in enumerate(st["micro"]):
            o = model.forward_train(mb["inputs"], mb["mask"], mb["mask_img"],
                                    st["eps"][a], needs_y)
            l = losses(cfg, mb, o, st["sim"][a])
            grads = torch.autograd.grad(l["all"], params, allow_unused=True)
            with torch.no_grad():
                for s, g in zip(acc, grads):
                    if g is not None:
                        s.add_(g)
                total = torch.sqrt(sum(g.square().sum() for g in acc))
                scale = torch.clamp_max(clip / (total + 1e-6), 1.0)
                for s in acc:
                    s.mul_(scale)
            loss_sum += float(l["all"].detach())
            for k, v in l.items():
                terms[k] = terms.get(k, 0.0) + float(v.detach())
            del o, l, grads
        seen = adam_amsgrad(params, acc, state, cfg["lr"],
                            cfg.get("weight_decay", 1e-5))
        if out["grad1"] is None:
            out["grad1"] = [g.norm().item() for g in seen]
        out["loss"].append(loss_sum)
        out["terms"].append(terms)
    return out


def synthesize(model: Reference, batch, source: int):
    """Eval-mode imputation of one request's batch."""
    model.eval()
    with torch.no_grad():
        return model.synthesize(batch["inputs"], batch["mask"],
                                batch["mask_img"], source)
