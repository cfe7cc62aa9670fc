"""The anatomy-code discriminator and the learned z prior against the JAX
package's, on the CPU in f32, and their weights carried both ways.

The model is the flagship structure at M=2, 32x64 with ``is_discrim_s`` and
``is_distri_z``.  The port's weights (torch init, with non-default
BatchNorm running statistics) reach the JAX model through the JAX
package's ``transplant_multimodal(..., discrim=True, notshared_impl=
'loop')``; the discriminator sees the anatomy codes of a pair of
modalities as two groups, each normalized with its own batch statistics in
train mode, with two ordered running-statistic updates.

Tolerances, with what was measured on a CPU: logits atol 1e-5 (measured
4.2e-7 in train mode, 3.7e-8 in eval mode); running statistics after the
train-mode forward rtol 1e-5, atol 1e-6 (measured at most 1.2e-7
absolute); the z prior atol 1e-6 (measured 3.6e-7).  The weight round
trips are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.main_missing import (
    build_model as jax_build_model)
from representation_disentanglement_tpu.utils.transplant import (
    transplant_multimodal)
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.discriminator import (
    Discriminator)
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.weights import from_jax_params

M, B, H, W, CS = 2, 3, 32, 64, 4
CFG = dict(contrast_list=["T1", "T1c"], input_height=H, input_width=W,
           batch_size=B, effective_batch=B, use_pallas=True,
           notshared_impl="loop", lambda_adv_s=0.1, lambda_kl=0.01,
           is_distri_z=True,
           others={"mod_enc_s": False, "ana_dec_act": "softmax",
                   "old": False, "softmax_remove_mask": True})
LOGIT_ATOL, STAT_RTOL, STAT_ATOL, PRIOR_ATOL = 1e-5, 1e-5, 1e-6, 1e-6


@pytest.fixture(scope="module")
def models():
    """(port model, its state_dict, the JAX model and its variables)."""
    cfg = Config(**CFG).derive().validate()
    port = build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    rs = np.random.default_rng(4)
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if "running" in name:
                buf.copy_(torch.from_numpy(rs.uniform(
                    0.5, 1.5, buf.shape).astype(np.float32)))
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    params, stats = transplant_multimodal(
        {k: v.numpy() for k, v in sd.items()}, M, (H, W), discrim=True,
        notshared_impl="loop")
    jcfg = JaxConfig(**CFG, remat=False).derive().validate()
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    return port, sd, jax_build_model(jcfg), variables


def _s_pair():
    """[2, B, H, W, Cs] anatomy-code-like inputs (softmax over channels)."""
    rs = np.random.default_rng(5)
    return rs.dirichlet(np.ones(CS), size=(2, B, H, W)).astype(np.float32)


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_jax(models, train):
    port, sd, jmodel, variables = models
    port.load_state_dict(sd, strict=True)
    port.train(train)
    s = _s_pair()
    got = port.discriminate(torch.from_numpy(s))
    fn = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=train, method=jmodel.discriminate,
        mutable=["batch_stats"] if train else False))
    out = fn(variables, jnp.asarray(s))
    want, new_stats = out if train else (out, None)
    assert got.shape == (2, B)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=LOGIT_ATOL)
    after = port.state_dict()
    want_sd = from_jax_params(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, new_stats["batch_stats"] if train
                     else variables["batch_stats"]),
        modality_num=M, input_size=(H, W))
    moved = 0
    for k in after:
        if k.startswith("discrim_s.") and "running" in k:
            np.testing.assert_allclose(after[k].numpy(), want_sd[k].numpy(),
                                       rtol=STAT_RTOL, atol=STAT_ATOL,
                                       err_msg=k)
            moved += not torch.equal(after[k], sd[k])
    # train mode: the four BatchNorms x mean and var moved; eval: none
    assert moved == (8 if train else 0)
    port.load_state_dict(sd, strict=True)


def test_discriminator_groups_are_normalized_apart(models):
    """Each group of the pair is normalized with its own statistics: the
    logits of group 0 do not depend on group 1's inputs."""
    port, sd, *_ = models
    port.load_state_dict(sd, strict=True)
    port.train()
    s = torch.from_numpy(_s_pair())
    a = port.discriminate(s)[0]
    s2 = s.clone()
    s2[1] = s2[1].flip(1)
    b = port.discriminate(s2)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    port.load_state_dict(sd, strict=True)


def test_z_prior_matches_jax(models):
    port, sd, jmodel, variables = models
    mean, log_var = port.z_prior()
    jm, jv = jax.jit(lambda v: jmodel.apply(v, method=jmodel.z_prior))(
        variables)
    assert mean.shape == log_var.shape == (M, 16)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jm),
                               rtol=0, atol=PRIOR_ATOL)
    np.testing.assert_allclose(log_var.detach().numpy(), np.asarray(jv),
                               rtol=0, atol=PRIOR_ATOL)


def test_discriminator_weights_round_trip_exactly(models):
    """port -> JAX -> port is the identity, and so is JAX -> port -> JAX
    for a JAX tree of the JAX model's structure holding random values."""
    port, sd, jmodel, variables = models
    back = from_jax_params(jax.tree.map(np.asarray, variables["params"]),
                           jax.tree.map(np.asarray,
                                        variables["batch_stats"]),
                           modality_num=M, input_size=(H, W))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the JAX model's own tree: shapes from tracing its init (nothing is
    # compiled), values random
    x = jnp.zeros((M, B, H, W, 7))
    shapes = jax.eval_shape(lambda k: jmodel.init(
        {"params": k}, x, jnp.ones((B, M)), jnp.zeros((B, H, W)),
        jax.random.PRNGKey(0), train=False, adv_pair=jnp.asarray([0, 1])),
        jax.random.PRNGKey(0))
    rs = np.random.default_rng(6)
    rand = lambda t: jax.tree.map(
        lambda a: rs.normal(size=a.shape).astype(np.float32), t)
    jp, js = rand(shapes["params"]), rand(shapes["batch_stats"])
    for name in ("discrim_s", "distri_z"):
        assert name in jp
    sd2 = from_jax_params(jp, js, modality_num=M, input_size=(H, W))
    p2, s2 = transplant_multimodal({k: v.numpy() for k, v in sd2.items()},
                                   M, (H, W), discrim=True,
                                   notshared_impl="loop")
    for want, got in ((jp, p2), (js, s2)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(a, b)


def test_discriminator_names_and_flatten_order():
    """The reference torch names, and fc.1 reading the last feature map in
    (C, H, W) order."""
    gen = torch.Generator().manual_seed(0)
    d = Discriminator(CS, (H, W), gen=gen)
    names = [n for n, _ in d.named_parameters()]
    assert names == [f"discrim.{i}.{w}" for i in (0, 2, 3, 5, 6, 8, 9, 11, 12)
                     for w in ("weight", "bias")] + [
        "fc.1.weight", "fc.1.bias", "fc.3.weight", "fc.3.bias"]
    assert d.fc[1].weight.shape == (256, 64 * (H // 32) * (W // 32))
