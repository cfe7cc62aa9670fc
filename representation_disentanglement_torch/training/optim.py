"""Optimizer, clipping and learning-rate schedule with the reference's
semantics (src/main_missing.py:118-122, 272, 282-289; JAX
training/optim.py).

- ``make_optimizer``: ``torch.optim.Adam(amsgrad=True)``, betas (0.9,
  0.999), eps 1e-8, the weight decay as L2 added to the gradient (not
  decoupled), which is what the JAX package's ``adam_amsgrad_torch``
  reproduces.
- ``make_d_optimizer``: the discriminator's Adam(amsgrad), no weight decay,
  over every parameter of the model, not the discriminator's alone (quirk
  Q3; reference main_missing.py:122, JAX train.py:162-166).
- ``clip_global_norm``: ``clip_grad_norm_`` with the JAX package's form,
  scale min(1, max / (total + 1e-6)); returns the norm before clipping.
- ``ReduceLROnPlateau``: a copy of the JAX package's host-side scheduler
  (mode 'min', relative threshold 1e-4, cooldown 0).  ``apply`` sets the
  optimizer's learning rate between steps.
- ``adam_state_from_jax`` / ``load_adam_state``: the JAX package's Adam
  state (``AdamAmsgradState``: ``count``, ``mu``, ``nu``, ``nu_max``, the
  same update) as torch Adam's (``step``, ``exp_avg``, ``exp_avg_sq``,
  ``max_exp_avg_sq``), so that a resumed run takes JAX's next step.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg
                   ) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay, amsgrad=True)


def make_d_optimizer(params: Iterable[torch.nn.Parameter], cfg
                     ) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0, amsgrad=True)


@torch.no_grad()
def clip_global_norm(grads, max_norm: float = 1.0) -> torch.Tensor:
    """Scale the tensors of ``grads`` in place so that their global L2
    norm is at most ``max_norm``; returns the f32 norm before scaling."""
    grads = list(grads)
    total = torch.sqrt(torch.stack([g.float().square().sum()
                                    for g in grads]).sum())
    scale = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return total


class ReduceLROnPlateau:
    """Host-side torch ReduceLROnPlateau parity (mode='min', relative
    threshold 1e-4, cooldown 0)."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 5,
                 min_lr: float = 1e-5, threshold: float = 1e-4):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def apply(self, *optimizers: torch.optim.Optimizer) -> None:
        """Set every param group's learning rate to the current one (the
        discriminator's step takes the same rate, JAX train.py:277-278)."""
        for optimizer in optimizers:
            for group in optimizer.param_groups:
                group["lr"] = self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d):
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]


def adam_state_from_jax(state: Dict, param_names: Sequence[str]) -> Dict:
    """A JAX Adam state whose moment trees are already in the port's names
    ({name: tensor}, layouts converted; the moments are elementwise, so the
    parameters' transposes carry over) -> the port's form: the shared
    ``step`` and one tensor per parameter in ``param_names`` order."""
    return {"jax_adam": True, "step": float(state["count"]),
            **{k: [state[j][n] for n in param_names] for k, j in (
                ("exp_avg", "mu"), ("exp_avg_sq", "nu"),
                ("max_exp_avg_sq", "nu_max"))}}


def load_adam_state(optimizer: torch.optim.Adam, state: Dict) -> None:
    """Load a checkpoint's ``opt_state`` into ``optimizer``: a torch
    ``state_dict``, or ``adam_state_from_jax``'s form (over the
    optimizer's parameters in order; raises ValueError when the counts
    differ)."""
    if not state.get("jax_adam"):
        optimizer.load_state_dict(state)
        return
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(params) != len(state["exp_avg"]):
        raise ValueError(f"a JAX Adam state of {len(state['exp_avg'])} "
                         f"tensors for {len(params)} parameters")
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(state["step"]),
                       **{k: state[k][i] for k in (
                           "exp_avg", "exp_avg_sq", "max_exp_avg_sq")}}
                   for i in range(len(params))}
    optimizer.load_state_dict(sd)
