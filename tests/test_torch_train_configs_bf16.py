"""One bf16 step of the EVERYTHING configuration of
tests/test_torch_train_configs.py (one microbatch, the KL to N(0, I))
against the JAX package's bf16 ``make_train_step``, on the CPU from the
same weights, at the bf16 tolerances of tests/test_torch_train_step.py:
the total rtol 5e-3 (measured 1.5e-3); every other term rtol 3e-2, atol
1e-6 (measured at most 1.0e-2, sim_s); the latent-z term, a mean of
|z_mean - z_mean_new| below the bf16 resolution of the z means, atol 5e-4
(measured 1.0e-5).

The KL is held against the port's own f32 step instead, rtol 3e-2
(measured 2.1e-3): the port computes every loss term in f32, while JAX's
KL (losses.py:139-142) adds its terms in the dtype of the z statistics, so
its bf16 value is 5.5% from its f32 value here.
"""

import numpy as np

from representation_disentanglement_torch.training import train
from tests.test_torch_train_configs import (  # noqa: F401
    ADV, B, EVERYTHING, SIM, few_threads, make_batch, port_step, run_both,
    start, z_is_the_mean)


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
