"""One training step's losses and gradients in the ``vgg`` options
configuration (the 'vmap' decoder halves, 'U+SA+CA', ``s_sim_method:
'perceptual'`` with ``s_compact_method: 'vgg'``; chip_smoke.py's
``train_options_vgg`` at test size) against the JAX package, on the CPU
with the same weights and the same random VGG16 npz
(tests/torch_options_common.py).

The similarity loss runs the anatomy codes of the drawn pair through the
learned ``vgg_pre`` projection and VGG16 in f32; ``vgg_pre`` gets a
gradient, the VGG16 weights are no parameters.  ``from_jax_grads`` reads
JAX's stacked 'vmap' gradient tree.

Both sides take z = the encoder mean.  Tolerances, with what was measured
on a CPU: losses rtol 1e-4 / atol 1e-7 (measured 7.7e-6 relative, sim_s
included); gradients leaf by leaf |port - JAX| <= 1e-3 max|JAX leaf| + 2e-5
(measured at most 2.2e-4 of the leaf's largest entry where that entry is
above 1e-3, on ``vgg_pre.bias``; rounding noise below 7e-9 on the biases
that feed a normalization).
"""

import pytest

from representation_disentanglement_tpu.training import train as jtrain
from representation_disentanglement_torch.training.train import (
    load_vgg_constants)
from torch_options_common import (
    check_grad, check_losses, jax_step, port_step)
import torch_options_common as C

two_threads = pytest.fixture(scope="module", autouse=True)(C.two_threads)
z_is_the_mean = pytest.fixture(scope="module", autouse=True)(
    C.z_is_the_mean)


@pytest.fixture(scope="module")
def step(z_is_the_mean, tmp_path_factory):
    pair = C.OptionPair("vgg", C.vgg_tmp(tmp_path_factory))
    data = C.batch()
    return pair, data, jax_step(pair, data,
                                jtrain.load_vgg_constants(pair.jcfg))


def test_step_losses_and_gradients_match_jax(step):
    pair, data, (want_l, want_g) = step
    model = pair.port()
    got_l, got_g = port_step(model, pair.cfg, data)
    check_losses(got_l, want_l)
    assert want_l["sim_s"] != 0.0
    assert set(got_g) == set(want_g)
    for name, g in want_g.items():
        check_grad(name, got_g[name], g)
    assert float(got_g["vgg_pre.weight"].abs().max()) > 0
    # the VGG16 weights are constants: neither parameters nor buffers
    consts = load_vgg_constants(pair.cfg, "cpu")
    held = {t.data_ptr() for t in model.state_dict().values()}
    assert not held & {t.data_ptr() for t in consts.values()}
    assert len(consts) == 26
