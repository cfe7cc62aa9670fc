"""Weights carried between the JAX package and the port.

``weights.from_jax_params`` turns the JAX model's trees into the port's
``state_dict`` (reference torch names); the JAX package's
``transplant_multimodal`` reads such a ``state_dict`` back.  The round trip
must give every leaf back exactly.  The JAX model is the flagship structure
(split SPADE decoder, loop halves, 'U+SA', CondConv) at M=2, 32x64.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.main_missing import (
    build_model as jax_build_model)
from representation_disentanglement_tpu.utils.transplant import (
    transplant_multimodal)
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.layers import (
    BatchNormTorch, MaybeCondConv, TorchLinear)
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.weights import from_jax_params

M, B, H, W = 2, 2, 32, 64
CFG = dict(contrast_list=["T1", "T1c"], input_height=H, input_width=W,
           batch_size=B, use_pallas=True, notshared_impl="loop",
           others={"mod_enc_s": False, "ana_dec_act": "softmax",
                   "old": False, "softmax_remove_mask": True})


@pytest.fixture(scope="module")
def jax_trees():
    """(params, batch_stats) of the JAX model, with non-default running
    statistics so that mean/var mix-ups show."""
    cfg = JaxConfig(**CFG, remat=False).derive().validate()
    model = jax_build_model(cfg)
    x = jnp.zeros((M, B, H, W, cfg.block_ch))
    mask, mask_img = jnp.ones((B, M)), jnp.zeros((B, H, W))

    def every_half(mod, x, mask, mask_img):
        return [mod.synthesize(x, mask, mask_img, source=i) for i in range(M)]

    v = jax.jit(lambda k: model.init(k, x, mask, mask_img,
                                     method=every_half))(
        jax.random.PRNGKey(0))
    rs = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(
        lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return params, stats


def _port(seed=0):
    cfg = Config(**CFG).derive().validate()
    return build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def test_from_jax_params_round_trips_exactly(jax_trees):
    params, stats = jax_trees
    sd = from_jax_params(params, stats, modality_num=M, input_size=(H, W))
    port = _port()
    port.load_state_dict(sd, strict=True)
    p2, s2 = transplant_multimodal(port.state_dict(), modality_num=M,
                                   input_size=(H, W), is_cond=True,
                                   shared_inp_dec=False,
                                   target_model_name="U+SA",
                                   notshared_impl="loop")
    for want, got in ((params, p2), (stats, s2)):
        wl = jax.tree_util.tree_leaves_with_path(want)
        gl = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(wl) == len(gl)
        for path, leaf in wl:
            assert path in gl, jax.tree_util.keystr(path)
            np.testing.assert_array_equal(np.asarray(gl[path]), leaf,
                                          err_msg=jax.tree_util.keystr(path))


def test_from_jax_params_rejects_unplaced_leaves(jax_trees):
    params, stats = jax_trees
    extra = dict(params, stray={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        from_jax_params(extra, stats, modality_num=M, input_size=(H, W))


def test_port_init_follows_torch_defaults():
    """kaiming-uniform bounds for conv/linear, xavier-normal CondConv
    experts with zero bias, BatchNorm ones/zeros; same seed, same weights."""
    port = _port(seed=3)
    n_cond = 0
    for name, mod in port.named_modules():
        if isinstance(mod, MaybeCondConv) and not mod.is_cond:
            fan_in = math.prod(mod.weight.shape[1:])
            assert mod.weight.abs().max() <= 1 / math.sqrt(fan_in), name
        elif isinstance(mod, MaybeCondConv):
            e, co, ci, kh, kw = mod.weight.shape
            std = math.sqrt(2.0 / ((co + e) * ci * kh * kw))
            if mod.weight.numel() > 10000:
                assert abs(mod.weight.std().item() / std - 1) < 0.05, name
            assert not mod.bias.any(), name
            n_cond += 1
        elif isinstance(mod, TorchLinear):
            bound = 1 / math.sqrt(mod.weight.shape[1])
            assert mod.weight.abs().max() <= bound, name
        elif isinstance(mod, BatchNormTorch):
            assert (mod.weight == 1).all() and not mod.bias.any()
    assert n_cond > 0
    again, other = _port(seed=3).state_dict(), _port(seed=4).state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(v, again[k]), k
    assert not torch.equal(port.state_dict()["output_decoder.down_1.0.weight"],
                           other["output_decoder.down_1.0.weight"])
