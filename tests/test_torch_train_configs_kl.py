"""The EVERYTHING configuration of tests/test_torch_train_configs.py with
the KL to N(0, I) (``is_distri_z`` off) against the JAX package's
``make_train_step``: the 3-step f32 trajectory of two microbatches, at
that file's tolerance (measured at most 1.6e-4 relative, sim_s of the
second step; 1.4e-4 on the gradient norm).
"""

from tests.test_torch_train_configs import (  # noqa: F401
    EVERYTHING, assert_trajectory, few_threads, make_batch, run_both, start,
    z_is_the_mean)


def test_everything_with_standard_kl_matches_jax(z_is_the_mean):
    got, want, *_ = run_both(EVERYTHING, start(EVERYTHING),
                             make_batch("seg"))
    assert_trajectory(got, want)
    for k in ("recon_y", "kl", "adv_s", "adv_s_d"):
        assert all(g[k] > 0 for g in got), k
