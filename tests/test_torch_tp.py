"""Channel tensor parallelism for NVNet3D (parallel/tp.py) on the CPU:
the eval forward with every 3D convolution's output channels split over
2 and 4 gloo processes and all-gathered, against the unsharded forward
(atol 1e-4; tests/test_tp_and_retrieval.py holds the JAX package's at
2e-4), and the sharding rule against the JAX package's
``channel_sharding`` (JAX tp.py:28-38).  NVNet3D with 2 contrasts,
``init_channels`` 16, at 16x32x32.
"""

import numpy as np
import pytest
import torch

from representation_disentanglement_torch.models.unet3d import build_nvnet3d
from representation_disentanglement_torch.parallel import mesh, tp
from tests import torch_parallel_workers as workers
from tests.test_torch_train_configs import few_threads  # noqa: F401

HWD, INIT = (16, 32, 32), 16


@pytest.mark.parametrize("n", [2, 4])
def test_channel_parallel_forward_matches_unsharded(n):
    model = build_nvnet3d(HWD, in_channels=2, init_channels=INIT,
                          device="cpu")
    x = torch.tensor(np.random.default_rng(0).normal(size=(1, 2) + HWD),
                     dtype=torch.float32)
    got = mesh.spawn(n, workers.tp_forward, HWD, INIT, model.state_dict(),
                     x, device="cpu")
    with torch.no_grad():
        want = model(x)
    for g, w, name in zip(got, want, ("uout", "vout", "mu", "logvar")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_channel_block_rule_matches_jax():
    from representation_disentanglement_tpu.parallel.tp import (
        channel_sharding, make_tp_mesh)
    for n in (2, 4, 8):
        jmesh = make_tp_mesh(n)
        for co in (1, 3, 4, 8, 12, 16, 24, 64):
            leaf = np.zeros((3, 3, 3, 2, co), np.float32)
            spec = channel_sharding(jmesh, leaf).spec
            assert tp.channel_sharding(co, n) == (len(spec) > 0
                                                  and spec[-1] == "model")
    w = torch.zeros(8, 2, 3, 3, 3)
    assert tp.channel_block(w, None)[0] is w            # outside a scope
    with tp.channel_parallel(mesh.Axis(None, 1, 2, (0, 1))):
        wb, bb, _ = tp.channel_block(torch.arange(8.).reshape(8, 1),
                                     torch.arange(8.))
        assert wb.flatten().tolist() == [4, 5, 6, 7] and bb[0] == 4
        assert tp.channel_block(torch.zeros(3, 1), None)[0].shape[0] == 3
