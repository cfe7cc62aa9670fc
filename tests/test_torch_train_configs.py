"""The port's train step with the s discriminator against the JAX
package's ``make_train_step``, on the CPU from the same weights: the
EVERYTHING loss set of tests/test_train_parity_full.py:46-49 (the BraTS
segmentation y with ``out_num_ch`` 4, the KL, the adversarial
s-discriminator step, the latent and sim terms) with the learned z prior
(``is_distri_z``), over 3 steps of two microbatches; and the adversarial
gradient carry (quirk Q10).  tests/test_torch_train_configs_y.py holds the
stage-2 freeze and ZeroDose; tests/test_torch_losses_configs.py the KL to
N(0, I) and every loss alone.

Model and data as tests/test_torch_train_step.py (M=2, 32x64, B=2, the
flagship structure) but with plain convolutions (``is_cond: False``): the
conditional convolutions are held against JAX by
tests/test_torch_train_{model,step}.py, and here would only add to the
compile time of the JAX step.  Both sides start from the port's torch
initialization with the zero-initialized biases made nonzero, carried to
JAX by ``transplant_multimodal`` (no JAX initialization is compiled), take
z = the encoder mean (``sample_z`` patched) and the sim and adversarial
pairs explicitly; one contrast is missing in one sample, the labels hold
every class 0-3.

Tolerance: every entry of the metrics vector of each step rtol 2e-3,
atol 1e-6, tests/test_torch_train_step.py's (measured at most 3.4e-4
relative, the gradient norm of the second step; 1.6e-4 on sim_s, at most
6.1e-5 on the others).
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
from representation_disentanglement_tpu.training import optim as joptim
from representation_disentanglement_tpu.training import train as jtrain
from representation_disentanglement_tpu.utils.transplant import (
    transplant_multimodal)
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.multimodal import (
    MultimodalModel, build_model)
from representation_disentanglement_torch.training import optim, train
from representation_disentanglement_torch.weights import from_jax_params

M, B, H, W, CB, A = 2, 2, 32, 64, 7, 2
BASE = dict(input_height=H, input_width=W, batch_size=B,
            effective_batch=A * B, use_pallas=True, notshared_impl="loop",
            is_cond=False,
            others={"mod_enc_s": False, "ana_dec_act": "softmax",
                    "old": False, "softmax_remove_mask": True})
EVERYTHING = dict(contrast_list=["T1", "T1c"], lambda_recon_y=1.0,
                  lambda_recon_y_fused=0.0, lambda_recon_x=1.0,
                  lambda_recon_x_mix=2.0, lambda_kl=0.01,
                  lambda_latent_z=0.1, lambda_sim_s=10.0, lambda_sim_z=2.0,
                  lambda_adv_s=0.1, out_num_ch=4)
STEPS = 3
SIM = np.array([[1, 0], [0, 1]], np.int32)
ADV = np.array([[0, 1], [1, 0]], np.int32)
RTOL, ATOL = 2e-3, 1e-6


def make_batch(targets: str):
    """[A, ...] microbatches: zero rows as background, contrast 0 missing
    in sample 1 of microbatch 0; ``targets`` 'seg' (labels 0-3, every
    class in each sample) or 'pet' (a nonnegative PET-like map)."""
    rs = np.random.default_rng(11)
    x = rs.normal(size=(A, M, B, H, W, CB)).astype(np.float32)
    x[:, :, :, :6] = 0.0
    x[0, 0, 1] = 0.0
    mask = np.ones((A, B, M), np.float32)
    mask[0, 1, 0] = 0.0
    mask_img = (x[:, 1, :, :, :, 0] == 0).astype(np.float32)
    if targets == "seg":
        t = rs.integers(0, 4, size=(A, B, H, W, 1)).astype(np.float32)
    else:
        t = np.abs(rs.normal(size=(A, B, H, W, 1))).astype(np.float32)
    return {"inputs": x, "mask": mask, "mask_img": mask_img, "targets": t}


def start(kw, seed: int = 1):
    """The port's initial weights (its torch init from ``seed``, the
    zero-initialized biases made nonzero) as its state_dict, and the JAX
    train state with the same weights, built by the JAX package's
    ``transplant_multimodal``, so that no JAX initialization is compiled."""
    cfg = Config(**dict(BASE, **kw)).derive().validate()
    port = build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    rs = np.random.default_rng(7)
    sd = {}
    for k, v in port.state_dict().items():
        if k.endswith(".bias") and not v.any():
            v = torch.from_numpy(rs.normal(0.0, 0.05, v.shape).astype(
                np.float32))
        sd[k] = v.clone()
    params, stats = transplant_multimodal(
        {k: v.numpy() for k, v in sd.items()}, M, (H, W),
        is_cond=cfg.is_cond, discrim=cfg.is_discrim_s,
        notshared_impl="loop")
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)
    tx = joptim.adam_amsgrad_torch(weight_decay=cfg.weight_decay)
    tx_d = joptim.adam_amsgrad_torch(weight_decay=0.0)
    adv = cfg.is_discrim_s
    zeros = jax.tree.map(jnp.zeros_like, params)
    state = jtrain.TrainState(params, stats, tx.init(params),
                              tx_d.init(params) if adv else (),
                              zeros if adv else ())
    return state, (tx, tx_d), sd


def port_state_dict(state):
    return from_jax_params(jax.tree.map(np.asarray, state.params),
                           jax.tree.map(np.asarray, state.batch_stats),
                           modality_num=M, input_size=(H, W))


def port_step(kw, sd):
    cfg = Config(**dict(BASE, **kw)).derive().validate()
    port = build_model(cfg, device="cpu")
    port.load_state_dict(sd, strict=True)
    opt = optim.make_optimizer(port.parameters(), cfg)
    dopt = optim.make_d_optimizer(port.parameters(), cfg) \
        if cfg.is_discrim_s else None
    return port, opt, train.make_train_step(port, cfg, opt, dopt)


def run_both(kw, start_, batch, steps=STEPS):
    """``steps`` f32 steps of both sides from ``start_`` (``start(kw)``).
    Returns the port's and JAX's metrics per step, the port model and
    optimizer and the last JAX state."""
    state, txs, sd = start_
    jcfg = JaxConfig(**dict(BASE, remat=False, **kw)).derive().validate()
    jstep, _ = jtrain.make_train_step(jax_build_model(jcfg), jcfg, txs,
                                      donate=False)
    port, opt, step = port_step(kw, sd)
    a = kw.get("effective_batch", A * B) // B            # microbatches
    batch = {k: v[:a] for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = jax.random.split(jax.random.PRNGKey(0), a)
    # with a y loss on, every step decodes y and first_of_epoch changes
    # nothing; JAX then compiles one program
    needs_y = kw.get("lambda_recon_y", 0) > 0 or \
        kw.get("lambda_recon_y_fused", 0) > 0
    got, want = [], []
    for i in range(steps):
        state, m = jstep(state, jb, rngs, jnp.asarray(SIM[:a]),
                         jnp.asarray(ADV[:a]), jnp.float32(jcfg.lr),
                         first_of_epoch=(i == 0) and not needs_y)
        want.append(jtrain.metrics_to_dict(m))
        got.append(train.metrics_to_dict(step(batch, None, SIM[:a], ADV[:a],
                                              first_of_epoch=(i == 0))))
    return got, want, port, opt, state


def assert_trajectory(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w) == list(train.METRIC_KEYS)
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {i}")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the workers of a parallel test run share the
    cores, and torch's thread pool slows many times over when they are
    oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def z_is_the_mean(monkeypatch):
    monkeypatch.setattr(JaxModel, "sample_z", lambda self, rng, m, lv: m)
    monkeypatch.setattr(MultimodalModel, "sample_z",
                        lambda self, gen, m, lv: m)


def test_everything_with_learned_prior_matches_jax(z_is_the_mean):
    kw = dict(EVERYTHING, is_distri_z=True)
    start_ = start(kw)
    got, want, port, _, _ = run_both(kw, start_, make_batch("seg"))
    assert_trajectory(got, want)
    for k in ("recon_y", "kl", "adv_s", "adv_s_d", "latent_z"):
        assert all(g[k] > 0 for g in got), k
    for name in ("distri_z.linear.2.weight", "discrim_s.fc.3.weight",
                 "discrim_s.discrim.0.weight"):
        assert not torch.equal(port.state_dict()[name], start_[2][name])

    # quirk Q10: the discriminator's gradients stay in .grad and start the
    # next step's accumulation; dropped after step 0, step 1 changes
    port, _, step = port_step(kw, start_[2])
    batch = make_batch("seg")
    again = []
    for i in range(2):
        again.append(train.metrics_to_dict(step(batch, None, SIM, ADV,
                                                first_of_epoch=(i == 0))))
        carry = torch.sqrt(sum(p.grad.square().sum()
                               for p in port.parameters()))
        assert float(carry) > 0
        for p in port.parameters():
            p.grad = None
    assert again[0] == got[0]
    assert again[1]["grad_norm"] != got[1]["grad_norm"]


def test_adversarial_step_needs_its_pairs_and_optimizer():
    cfg = Config(**BASE, **EVERYTHING).derive().validate()
    port = build_model(cfg, device="cpu")
    opt = optim.make_optimizer(port.parameters(), cfg)
    with pytest.raises(ValueError, match="discriminator's optimizer"):
        train.make_train_step(port, cfg, opt)
    step = train.make_train_step(port, cfg, opt, optim.make_d_optimizer(
        port.parameters(), cfg))
    with pytest.raises(ValueError, match="adv_pairs"):
        step(make_batch("seg"), None, SIM)
