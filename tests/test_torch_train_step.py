"""The port's train step against the JAX package's ``make_train_step``, on
the CPU from the same weights: a 3-step f32 loss trajectory with the
metrics vector, and one bf16 step.

Model and data as tests/test_torch_train_model.py (M=2, 32x64, B=2, the
flagship structure, the shipped five losses, one missing contrast, small
nonzero values in the zero-initialized biases for the reason given there).
Both sides take z = the encoder mean (``sample_z`` patched) and the sim
pair (1, 0) explicitly; step 0 is the first of its epoch, so it also runs
the y decodes (``compute_y``).

Tolerances, with what was measured on a CPU:
- f32, each of the 3 steps, every entry of the metrics vector (the loss
  terms, their weighted sum and the gradient norm): rtol 2e-3, atol 1e-6
  (measured at most 3.6e-4 relative, on the latent-z term, 1.1e-4 on the
  gradient norm, at most 1.4e-5 on the others);
- bf16, one step against JAX's bf16 step: the total loss rtol 5e-3
  (measured 9.0e-4), the reconstruction and sim terms and the gradient
  norm rtol 3e-2 (measured at most 1.4e-2, the gradient norm; JAX's own
  bf16 step is 1.3e-2 from its f32 step there).  The latent-z term, a mean
  of |z_mean - z_mean_new| of about 1e-4, is below the bf16 resolution of
  the z means it subtracts: JAX's bf16 value is 1.4x away from its f32
  value, the port's 2.6x.  It is held to atol 5e-4, about one bf16 ulp of
  those z means, and not to a relative tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.main_missing import (
    build_model as jax_build_model)
from representation_disentanglement_tpu.models.multimodal import (
    MultimodalModel as JaxModel)
from representation_disentanglement_tpu.training import train as jtrain
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.multimodal import (
    MultimodalModel, build_model)
from representation_disentanglement_torch.training import optim, train
from representation_disentanglement_torch.weights import from_jax_params

M, B, H, W, CB = 2, 2, 32, 64, 7
CFG = dict(contrast_list=["T1", "T1c"], input_height=H, input_width=W,
           batch_size=B, effective_batch=B, use_pallas=True,
           notshared_impl="loop",
           others={"mod_enc_s": False, "ana_dec_act": "softmax",
                   "old": False, "softmax_remove_mask": True})
STEPS = 3
PAIRS = np.array([[1, 0]], np.int32)


def _batch():
    rs = np.random.default_rng(11)
    x = rs.normal(size=(M, B, H, W, CB)).astype(np.float32)
    x[:, :, :6] = 0.0
    x[0, 1] = 0.0
    mask = np.ones((B, M), np.float32)
    mask[1, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    return {"inputs": x[None], "mask": mask[None], "mask_img": mask_img[None],
            "targets": np.zeros((1, B, H, W, 1), np.float32)}


@pytest.fixture(scope="module")
def start():
    """JAX train state (zero-initialized biases made nonzero) and the
    port's state_dict with the same weights."""
    jcfg = JaxConfig(**CFG, remat=False).derive().validate()
    jmodel = jax_build_model(jcfg)
    batch = _batch()
    sample = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    state, txs = jtrain.create_train_state(jmodel, jcfg,
                                           jax.random.PRNGKey(1), sample)
    rs = np.random.default_rng(7)

    def fix(path, a):
        if path[-1].key == "bias" and not np.any(np.asarray(a)):
            return jnp.asarray(rs.normal(0.0, 0.05, a.shape), jnp.float32)
        return a

    state = state._replace(
        params=jax.tree_util.tree_map_with_path(fix, state.params))
    sd = from_jax_params(jax.tree.map(np.asarray, state.params),
                         jax.tree.map(np.asarray, state.batch_stats),
                         modality_num=M, input_size=(H, W))
    return state, txs, sd, batch


@pytest.fixture
def z_is_the_mean(monkeypatch):
    monkeypatch.setattr(JaxModel, "sample_z", lambda self, rng, m, lv: m)
    monkeypatch.setattr(MultimodalModel, "sample_z",
                        lambda self, gen, m, lv: m)


def _run(start, compute_dtype, steps):
    state, txs, sd, batch = start
    jcfg = JaxConfig(**CFG, remat=False,
                     compute_dtype=compute_dtype).derive().validate()
    jmodel = jax_build_model(jcfg)
    jstep, n_micro = jtrain.make_train_step(jmodel, jcfg, txs, donate=False)
    assert n_micro == 1
    cfg = Config(**CFG, compute_dtype=compute_dtype).derive().validate()
    port = build_model(cfg, device="cpu")
    port.load_state_dict(sd, strict=True)
    step = train.make_train_step(port, cfg, optim.make_optimizer(
        port.parameters(), cfg))
    gen = torch.Generator().manual_seed(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, got = [], []
    for i in range(steps):
        state, m = jstep(state, jb, jax.random.split(jax.random.PRNGKey(i), 1),
                         jnp.asarray(PAIRS), jnp.asarray(PAIRS),
                         jnp.float32(jcfg.lr), first_of_epoch=(i == 0))
        want.append(jtrain.metrics_to_dict(m))
        got.append(train.metrics_to_dict(
            step(batch, gen, PAIRS, first_of_epoch=(i == 0))))
    return got, want


def test_f32_trajectory_matches_jax(start, z_is_the_mean):
    got, want = _run(start, "float32", STEPS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w) == list(train.METRIC_KEYS)
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   rtol=2e-3, atol=1e-6, err_msg=f"step {i}")
    assert got[-1]["all"] != got[0]["all"]         # the weights did move


def test_bf16_step_matches_jax_bf16_step(start, z_is_the_mean):
    (got,), (want,) = _run(start, "bfloat16", 1)
    assert np.isfinite(list(got.values())).all()
    np.testing.assert_allclose(got["all"], want["all"], rtol=5e-3)
    for k in ("recon_x", "recon_x_mix", "sim_s", "sim_z", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=3e-2, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["latent_z"], want["latent_z"], rtol=0,
                               atol=5e-4)
