"""One bf16 step of the EVERYTHING configuration of
tests/test_torch_train_configs.py (one microbatch, the KL to N(0, I)), and
one of the ZeroDose configuration of tests/test_torch_train_configs_y.py
with its two microbatches (accumulated and clipped after each, as
configs/zerodose_pet.yaml trains), against the JAX package's bf16
``make_train_step``, on the CPU from the same weights, at the bf16
tolerances of tests/test_torch_train_step.py:
the total rtol 5e-3 (measured 1.5e-3); every other term rtol 3e-2, atol
1e-6 (measured at most 1.0e-2, sim_s); the latent-z term, a mean of
|z_mean - z_mean_new| below the bf16 resolution of the z means, atol 5e-4
(measured 1.0e-5).

The KL is held against the port's own f32 step instead, rtol 3e-2
(measured 2.1e-3): the port computes every loss term in f32, while JAX's
KL (losses.py:139-142) adds its terms in the dtype of the z statistics, so
its bf16 value is 5.5% from its f32 value here.  ZeroDose's two
microbatches hold every other term at these tolerances (measured: the
total 1.6e-3, the others at most 5.1e-3, sim_s), and two terms against the
port's f32 step (the test's docstring): in bf16 they are rounding noise in
both packages (over six other batches, one microbatch each, the gradient
norm lay up to 3.5% from f32 in the port and 9.9% in JAX, the latent-z
term up to 4.1% and 1.4%, with mixed signs), and both packages' f32 steps
agree on them exactly.
"""

import numpy as np
import torch

from representation_disentanglement_torch.training import train
from tests.test_torch_train_configs import (  # noqa: F401
    ADV, B, EVERYTHING, SIM, few_threads, make_batch, port_step, run_both,
    start, z_is_the_mean)
from tests.test_torch_train_configs_y import ZERODOSE


def test_everything_bf16_step_matches_jax_bf16_step(z_is_the_mean):
    kw = dict(EVERYTHING, effective_batch=B, compute_dtype="bfloat16")
    start_ = start(kw)
    batch = make_batch("seg")
    (got,), (want,), *_ = run_both(kw, start_, batch, steps=1)
    assert np.isfinite(list(got.values())).all()
    np.testing.assert_allclose(got["all"], want["all"], rtol=5e-3)
    for k in ("recon_y", "recon_x", "recon_x_mix", "sim_s", "sim_z",
              "adv_s", "adv_s_d", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=3e-2, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["latent_z"], want["latent_z"], rtol=0,
                               atol=5e-4)
    _, _, step = port_step(dict(kw, compute_dtype="float32"), start_[2])
    f32 = train.metrics_to_dict(step({k: v[:1] for k, v in batch.items()},
                                     None, SIM[:1], ADV[:1],
                                     first_of_epoch=True))
    np.testing.assert_allclose(got["kl"], f32["kl"], rtol=3e-2)


def latent_resolution(model, batch) -> float:
    """The bf16 resolution of the latent-z metric: per microbatch, over the
    present (modality, sample) pairs, the mean of the sum over z of half a
    bf16 ulp of z_mean and of z_mean_new (the f32 train forward's), summed
    over the microbatches as the metric is."""
    total = 0.0
    model.train()
    for a in range(batch["inputs"].shape[0]):
        mask = torch.as_tensor(batch["mask"][a]).t()              # [M, B]
        with torch.no_grad():
            out = model(torch.as_tensor(batch["inputs"][a]),
                        torch.as_tensor(batch["mask"][a]),
                        torch.as_tensor(batch["mask_img"][a]), None,
                        compute_y=False, latent_cycle=True)
        half_ulps = 0.0
        for z in (out["z_mean"], out["z_mean_new"]):
            _, e = torch.frexp(z.abs().clamp_min(2.0 ** -100))
            half_ulps = half_ulps + torch.pow(2.0, (e - 9).float())
        total += float(((half_ulps.sum(-1) * mask).sum(1)
                        / mask.sum(1)).mean())
    return total


def test_zerodose_bf16_two_microbatches_match_jax_bf16_step(z_is_the_mean):
    """The gradient norm and the latent-z term are held against the port's
    f32 step, which equals JAX's f32 step here: the gradient norm at rtol
    3e-2 (measured 4.0e-3; JAX's bf16 norm lies 4.2% from it); the latent-z
    term, whose per-element differences (about 1e-3 at |z| about 0.09) are
    two bf16 ulps of the z means, within ``latent_resolution`` of it, on
    both sides (measured: the port 1.5e-3, JAX 6.3e-5, the bound 1.7e-2);
    the two lie 1.5e-3 apart, beyond the 5e-4 that the EVERYTHING case
    holds."""
    kw = dict(ZERODOSE, effective_batch=2 * B, compute_dtype="bfloat16")
    start_ = start(kw)
    batch = make_batch("pet")
    (got,), (want,), *_ = run_both(kw, start_, batch, steps=1)
    assert np.isfinite(list(got.values())).all()
    np.testing.assert_allclose(got["all"], want["all"], rtol=5e-3)
    for k in ("recon_y", "recon_y_fused", "recon_x", "recon_x_mix", "sim_s",
              "sim_z"):
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=3e-2, atol=1e-6,
                                   err_msg=k)
    port32, _, step = port_step(dict(kw, compute_dtype="float32"),
                                start_[2])
    res = latent_resolution(port32, batch)
    f32 = train.metrics_to_dict(step(batch, None, SIM, ADV,
                                     first_of_epoch=True))
    np.testing.assert_allclose(got["grad_norm"], f32["grad_norm"],
                               rtol=3e-2)
    for side in (got, want):
        assert abs(side["latent_z"] - f32["latent_z"]) <= res
