"""One training step's losses and gradients in the ``full`` options
configuration (SPADEFull, ``mod_enc_s``, 'U+SSA+CA'; the configuration of
chip_smoke.py's ``train_options_full`` at test size) against the JAX
package, on the CPU with the same weights (tests/torch_options_common.py).

The JAX step is ``train.assemble_losses`` over the train-mode forward with
the latent cycle and the y decodes, differentiated by ``jax.grad``; its
gradient tree reaches the port's parameter names through
``weights.from_jax_grads``.  With ``mod_enc_s`` the latent cycle's
re-encoded anatomy feeds the modality encoder, so the loss reaches the
anatomy encoder through it too.  The per-modality model (the JAX package
cannot run one, tests/torch_options_common.py) with M copies of the shared
weights and the fused BatchNorm computes the same losses, and the
gradients of its M copies sum to the shared encoder's.

Both sides take z = the encoder mean.  Tolerances (those of
tests/test_torch_train_model.py), with what was measured on a CPU: losses
rtol 1e-4 / atol 1e-7 (measured 6.7e-7 relative); gradients leaf by leaf
|port - JAX| <= 1e-3 max|JAX leaf| + 2e-5 (measured at most 1.5e-4 of the
leaf's largest entry where that entry is above 1e-3, 1.2e-4 for the
per-modality shares' sum; a bias that feeds a normalization has a
gradient of rounding noise, at most 1.9e-7, on both sides).
"""

import pytest

from torch_options_common import (
    check_grad, check_losses, jax_step, port_step)
import torch_options_common as C

two_threads = pytest.fixture(scope="module", autouse=True)(C.two_threads)
z_is_the_mean = pytest.fixture(scope="module", autouse=True)(
    C.z_is_the_mean)
NAME = "full"


@pytest.fixture(scope="module")
def step(z_is_the_mean):
    pair = C.OptionPair(NAME)
    data = C.batch()
    return pair, data, jax_step(pair, data)


def test_step_losses_and_gradients_match_jax(step, monkeypatch):
    pair, data, (want_l, want_g) = step
    got_l, got_g = port_step(pair.port(), pair.cfg, data)
    check_losses(got_l, want_l)
    assert set(got_g) == set(want_g)
    for name, g in want_g.items():
        check_grad(name, got_g[name], g)
    # the latent cycle's re-encoded anatomy reaches the loss (mod_enc_s)
    assert got_g["anatomy_encoder_enc_list.0.down_1.bias"].abs().max() > 0


def test_per_modality_step_sums_to_the_shared_one(step):
    """Per-modality encoders with copies of the shared weights and the
    fused BatchNorm: the same losses; each copy's gradient is its
    modality's share, and the shares sum to the shared gradient."""
    pair, data, (want_l, want_g) = step
    cfg = C.Config(**dict(C.BASE, **C.OPTIONS[NAME], shared_ana_enc=False,
                          shared_mod_enc=False, fuse_bn=True)).derive()
    got_l, got_g = port_step(pair.port(cfg, C.per_modality_sd(pair.sd)),
                             cfg, data)
    check_losses(got_l, want_l)
    roots = ("anatomy_encoder_enc_list.0.", "modality_encoder_list.0.")
    for name, g in want_g.items():
        root = next((r for r in roots if name.startswith(r)), None)
        if root is None:
            check_grad(name, got_g[name], g)
            continue
        shares = [got_g[root[:-2] + f"{m}." + name[len(root):]]
                  for m in range(C.M)]
        check_grad(name, sum(shares), g)
        if float(g.abs().max()) > 0:       # no loss reaches log_var here
            assert all(float(s.abs().max()) > 0 for s in shares), name
