"""The port's depth-sharded whole-volume 3D path (ops/conv3d.py's halo and
all-reduced variants, parallel/halo.py, training/train3d.py's
``make_sharded_train_step_3d``) on the CPU: gloo processes, NVNet3D with 2
contrasts, ``init_channels`` 8, at 16x16x64 (a 16-slice block per rank at
4 depth shards, D/16 = 4), f32.

- the halo exchange at 3 ranks, forward and backward, against a zero pad;
- one sharded optimizer step, depth-only at 2 and 4 shards and composed 2
  x 2 (data x depth, batch 2), against the unsharded port step from the
  same weights: loss terms rtol 1e-5, gradient norm rtol 1e-3, parameters
  atol 3e-4 (tests/test_unet3d.py's limits: the first Adam step moves a
  weight by about lr = 1e-4 times the sign of its gradient); with the
  generator's dropout and eps drawn at the global shape, so the sharded
  step draws the unsharded step's noise; the depth-sharded inference from
  the same weights against the unsharded forward at atol 1e-4;
- the same depth-2 step and inference (no noise) against the JAX package's
  ``make_sharded_train_step_3d`` and ``sharded_nvnet_infer_fn`` on a
  2-device depth mesh of the virtual CPU mesh, at the same limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_torch.models.unet3d import build_nvnet3d
from representation_disentanglement_torch.parallel import mesh
from representation_disentanglement_torch.training import train3d
from tests import torch_parallel_workers as workers
from tests.test_torch_train_configs import few_threads  # noqa: F401
from tests.test_torch_unet3d import to_jax_nvnet3d

HWD = (16, 16, 64)
INIT, LR = 8, 1e-4


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.default_rng(0)
    batch = {"inputs": torch.tensor(rs.normal(size=(2, 2) + HWD),
                                    dtype=torch.float32),
             "targets": torch.tensor(rs.integers(0, 4, (2, 1) + HWD),
                                     dtype=torch.float32)}
    sd = build_nvnet3d(HWD, in_channels=2, init_channels=INIT,
                       device="cpu").state_dict()
    one = {k: v[:1] for k, v in batch.items()}
    return batch, one, sd


CASES = {"depth2": (2, 1, None), "depth2_noise": (2, 1, 5),
         "depth4_noise": (4, 1, 5), "data2_depth2_noise": (2, 2, 5)}


@pytest.fixture(scope="module")
def runs(inputs):
    batch, one, sd = inputs
    out = {}
    for world in (2, 4):
        names = [k for k, (nd, na, _) in CASES.items() if nd * na == world]
        jobs = [("volume_steps", (HWD, INIT, CASES[k][0], CASES[k][1], sd,
                                  batch if CASES[k][1] > 1 else one,
                                  CASES[k][2])) for k in names]
        out.update(zip(names, mesh.spawn(world, workers.run_jobs, jobs,
                                         device="cpu")))
    return out


def unsharded(sd, batch, seed):
    model = build_nvnet3d(HWD, in_channels=2, init_channels=INIT,
                          device="cpu")
    model.load_state_dict(sd)
    step = train3d.make_train_step_3d(model, train3d.create_state_3d(
        model, lr=LR))
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    model.eval()
    with torch.no_grad():
        out = model(batch["inputs"])
    m = step(batch, gen)
    return {k: float(v) for k, v in m.items()}, model.state_dict(), out


def assert_close(got, want, what=""):
    gm, gsd, gout = got
    wm, wsd, wout = want
    for k in ("loss", "dice_loss", "vae_recon", "kl"):
        np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5,
                                   err_msg=f"{what} {k}")
    np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"], rtol=1e-3)
    for k in wsd:
        np.testing.assert_allclose(np.asarray(gsd[k]), np.asarray(wsd[k]),
                                   atol=3e-4, rtol=0, err_msg=f"{what} {k}")
    for g, w, name in zip(gout, wout, ("uout", "vout", "mu", "logvar")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_and_inference_match_unsharded(runs, inputs, case):
    batch, one, sd = inputs
    nd, na, seed = CASES[case]
    assert_close(runs[case], unsharded(sd, batch if na > 1 else one, seed),
                 case)


def test_halo_exchange_forward_and_backward():
    """At 3 ranks of 2 slices: each rank's block with its neighbours' edge
    slices (zeros at the volume's ends), and the gradient of sum(w * y),
    w the index within y, reaching every slice from each copy of it."""
    x = torch.arange(2 * 3 * 4 * 4 * 6, dtype=torch.float32).reshape(
        2, 3, 4, 4, 6)
    y, g = mesh.spawn(3, workers.halo_grad, x, device="cpu")
    pad = torch.nn.functional.pad(x, (1, 1))
    want = torch.zeros_like(x)
    for r in range(3):
        assert torch.equal(y[r], pad[..., 2 * r:2 * r + 4]), r
        w = torch.arange(y[r].numel(), dtype=torch.float32).reshape(
            y[r].shape)
        for k in range(4):
            j = 2 * r + k - 1                 # the global slice at y[.., k]
            if 0 <= j < 6:
                want[..., j] += w[..., k]
    assert torch.equal(torch.cat(list(g), -1), want)


def test_sharded_step_and_inference_match_jax(runs, inputs):
    from representation_disentanglement_tpu.models.unet3d import (
        NVNet3D as JaxNVNet3D)
    from representation_disentanglement_tpu.parallel.halo import (
        make_depth_mesh, sharded_nvnet_infer_fn)
    from representation_disentanglement_tpu.training.optim import (
        adam_amsgrad_torch)
    from representation_disentanglement_tpu.training.train3d import (
        Train3DState, make_sharded_train_step_3d)
    from representation_disentanglement_torch.weights import (
        from_jax_nvnet3d)

    _, one, sd = inputs
    H, W, D = HWD
    model = JaxNVNet3D(input_shape=(D, H, W), in_channels=2, out_channels=3,
                       init_channels=INIT, dropout_p=0.2)
    params = jax.tree.map(jnp.asarray, to_jax_nvnet3d(sd, HWD))
    tx = adam_amsgrad_torch(weight_decay=1e-5)
    state = Train3DState(params, tx.init(params), jnp.zeros([], jnp.int32))
    x = jnp.asarray(np.moveaxis(one["inputs"].numpy(), (1, 4), (4, 1)))
    t = jnp.asarray(np.moveaxis(one["targets"].numpy(), (1, 4), (4, 1)))
    dmesh = make_depth_mesh(2)
    uout, vout, mu, lv = sharded_nvnet_infer_fn(model, dmesh)(
        {"params": state.params}, x)
    step = make_sharded_train_step_3d(model, tx, dmesh, donate=False)
    state, m = step(state, {"inputs": x, "targets": t}, None,
                    jnp.float32(LR))
    want_sd = from_jax_nvnet3d(jax.tree.map(np.asarray, state.params),
                               (D, H, W))
    back = lambda a: np.moveaxis(np.asarray(a), (4, 1), (1, 4))
    want = ({k: float(v) for k, v in m.items()}, want_sd,
            [back(uout), back(vout), np.asarray(mu), np.asarray(lv)])
    assert_close(runs["depth2"], want, "jax")
