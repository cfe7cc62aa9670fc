"""The losses of the remaining 2D configurations against the JAX package's,
on the CPU in f32: the y reconstruction losses, the BraTS segmentation
losses, both KL forms and both outputs of the adversarial loss, under the
masks of tests/test_torch_train_ops.py (all present, one missing, a
modality absent from the batch, all missing), with labels holding every
class 0-3.

Tolerance: rtol 1e-5, atol 1e-6, on values and on the gradients with
respect to every input (measured at most 3.0e-7 relative on the values
and 4.8e-7 absolute on the gradients).  An all-missing mask gives exactly
0.0 for every masked loss, with finite zero gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu import losses as JL
from representation_disentanglement_torch import losses

RTOL, ATOL = 1e-5, 1e-6
M, B, H, W, Z = 3, 4, 8, 16, 16
MASKS = {
    "all_present": np.ones((B, M), np.float32),
    "one_missing": np.array([[1, 0, 1], [1, 1, 1], [0, 1, 1], [1, 1, 0]],
                            np.float32),
    "modality_absent": np.array([[1, 0, 1], [1, 0, 1], [0, 0, 1],
                                 [1, 0, 1]], np.float32),
    "all_missing": np.zeros((B, M), np.float32),
}


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.default_rng(21)
    labels = rs.integers(0, 4, size=(B, H, W, 1)).astype(np.float32)
    labels[:, 0, :4, 0] = [0, 1, 2, 3]            # every class in each sample
    return {
        "seg_gt": labels,
        "y_logits": rs.normal(size=(M, B, H, W, 4)).astype(np.float32),
        "pet_gt": np.abs(rs.normal(size=(B, H, W, 1))).astype(np.float32),
        "y_img": rs.normal(size=(M, B, H, W, 1)).astype(np.float32),
        "z_mean": rs.normal(size=(M, B, Z)).astype(np.float32),
        "z_log_var": (0.5 * rs.normal(size=(M, B, Z))).astype(np.float32),
        "prior_mean": rs.normal(size=(M, Z)).astype(np.float32),
        "prior_log_var": (0.5 * rs.normal(size=(M, Z))).astype(np.float32),
        "d_logits": (2.0 * rs.normal(size=(2, B))).astype(np.float32),
    }


# (name, inputs it reads, port function, JAX function); each function takes
# (dict of arrays, mask) and returns the loss or a tuple of losses
def _cases(p):
    return [
        ("recon_y", ("pet_gt", "y_img"),
         lambda d, m, L: L.recon_loss_y(d["pet_gt"], d["y_img"][0], p=p)),
        ("recon_y_list", ("pet_gt", "y_img"),
         lambda d, m, L: L.recon_loss_y_list(d["pet_gt"], d["y_img"], m,
                                             p=p)),
        ("segmentation_y", ("seg_gt", "y_logits"),
         lambda d, m, L: L.segmentation_loss_y(d["seg_gt"],
                                               d["y_logits"][0])),
        ("segmentation_y_list", ("seg_gt", "y_logits"),
         lambda d, m, L: L.segmentation_loss_y_list(d["seg_gt"],
                                                    d["y_logits"], m)),
        ("kl_standard", ("z_mean", "z_log_var"),
         lambda d, m, L: L.kl_loss_standard_list(d["z_mean"],
                                                 d["z_log_var"], m)),
        ("kl_two_gaussian", ("z_mean", "z_log_var", "prior_mean",
                             "prior_log_var"),
         lambda d, m, L: L.kl_loss_two_gaussian_list(
             d["z_mean"], d["z_log_var"], d["prior_mean"],
             d["prior_log_var"], m)),
        ("adversarial", ("d_logits",),
         lambda d, m, L: L.adversarial_loss(d["d_logits"], m[:, [2, 0]].T)),
    ]


# p reaches only the reconstruction losses
CASE_P = [(c[0], p) for c in _cases(1)
          for p in ((1, 2) if c[0].startswith("recon") else (1,))]


def _port(fn, d, keys, mask):
    """Values and input gradients of the port's loss (a scalar or the sum
    of a tuple's entries for the gradient)."""
    t = {k: torch.from_numpy(d[k]).requires_grad_(k != "seg_gt")
         for k in keys}
    out = fn(t, torch.from_numpy(mask), losses)
    vals = out if isinstance(out, tuple) else (out,)
    total = sum(vals)
    if total.requires_grad:
        total.backward()
    grads = {k: (v.grad.numpy() if v.grad is not None
                 else np.zeros_like(d[k])) for k, v in t.items()
             if k != "seg_gt"}
    return [float(v.detach()) for v in vals], grads


def _jax(fn, d, keys, mask):
    diff = [k for k in keys if k != "seg_gt"]

    def f(*xs):
        a = dict(zip(diff, xs))
        a.update({k: jnp.asarray(d[k]) for k in keys if k == "seg_gt"})
        out = fn(a, jnp.asarray(mask), JL)
        vals = out if isinstance(out, tuple) else (out,)
        return sum(vals), vals

    (_, vals), grads = jax.value_and_grad(
        f, argnums=tuple(range(len(diff))), has_aux=True)(
            *[jnp.asarray(d[k]) for k in diff])
    return [float(v) for v in vals], dict(zip(diff, map(np.asarray, grads)))


@pytest.mark.parametrize("mask_name", list(MASKS))
@pytest.mark.parametrize("case,p", CASE_P)
def test_loss_matches_jax(inputs, case, mask_name, p):
    name, keys, fn = next(c for c in _cases(p) if c[0] == case)
    mask = MASKS[mask_name]
    got, gg = _port(fn, inputs, keys, mask)
    want, gw = _jax(fn, inputs, keys, mask)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for k in gw:
        assert np.isfinite(gg[k]).all(), k
        np.testing.assert_allclose(gg[k], gw[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    masked = name not in ("recon_y", "segmentation_y")
    if mask_name == "all_missing" and masked:
        assert got == [0.0] * len(got)
        assert all(not g.any() for g in gg.values())


def test_segmentation_weights_divide_by_the_summed_pixel_weights(inputs):
    """The class-weighted mean divides by the summed per-pixel weights
    (torch's ``weight=`` mean), checked against numpy."""
    gt, y = inputs["seg_gt"], inputs["y_logits"][0]
    lab = gt[..., 0].astype(int)
    logp = y - np.log(np.exp(y).sum(-1, keepdims=True))
    w = np.array([1.0, 5.0, 5.0, 5.0])[lab]
    ce = -(w * np.take_along_axis(logp, lab[..., None], -1)[..., 0]).sum() \
        / w.sum()
    prob = np.exp(logp)
    dice = sum(1.0 - 2.0 * (prob[..., i] * (lab == i)).sum()
               / ((prob[..., i] ** 2 + (lab == i)).sum() + 1e-6)
               for i in (1, 2, 3)) / 3.0
    got = losses.segmentation_loss_y(torch.from_numpy(gt),
                                     torch.from_numpy(y))
    np.testing.assert_allclose(float(got), ce + dice, rtol=RTOL)


def test_adversarial_generator_term_keeps_quirk_q4(inputs):
    """The generator term of the second modality is its discriminator term
    (both target ones)."""
    d = torch.from_numpy(inputs["d_logits"])
    ones = torch.ones(2, B)
    d_loss, g_loss = losses.adversarial_loss(d, ones)
    bce = lambda x, t: torch.nn.functional.binary_cross_entropy_with_logits(
        x, torch.full_like(x, t))
    np.testing.assert_allclose(float(d_loss), float(0.5 * (bce(d[0], 0.0)
                                                           + bce(d[1], 1.0))),
                               rtol=RTOL)
    np.testing.assert_allclose(float(g_loss), float(0.5 * (bce(d[0], 1.0)
                                                           + bce(d[1], 1.0))),
                               rtol=RTOL)
