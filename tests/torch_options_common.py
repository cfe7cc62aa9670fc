"""Shared set-up of the parity tests of the 2D model options
(tests/test_torch_model_options.py, test_torch_generators_options.py,
test_torch_train_options_full.py, test_torch_train_options_vgg.py,
test_torch_vgg.py): the configurations, JAX variables with the tree
structure of ``model.init`` and random values from a seed (no JAX init is
compiled: ``jax.eval_shape`` gives the structure), a random VGG16 npz, and
the port's model with the same weights through ``weights.from_jax_params``.

The configurations, at M=2, B=2, 32x64, f32, the JAX model with
``remat=False`` and CondConv where not ``old``:
- ``full``: ``shared_inp_dec`` (SPADEFull), ``mod_enc_s`` (the default when
  ``others`` lacks the key) and the 'U+SSA+CA' decoder;
- ``vgg``: the 'vmap' decoder halves, 'U+SA+CA', ``s_sim_method:
  'perceptual'`` and ``s_compact_method: 'vgg'`` (``vgg_pre``);
- ``old``: ``others.old`` (non-conditional convolutions and SPADEFull) and
  the 'U' decoder.

The JAX package cannot run per-modality encoders (``shared_ana_enc`` /
``shared_mod_enc: False``): flax's ``nn.vmap`` does not pass the ``train``
keyword on to ``AnatomyEncoderEnc``, and ``ModalityEncoder`` flattens as if
a group axis led, which the vmap removed.  Their tests hold the port
against JAX's modules applied to one modality each (what the vmap is meant
to compute), and against the JAX model with shared encoders, whose
forward a per-modality model with M copies of the shared weights equals.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.models.multimodal import (
    MultimodalModel as JaxModel)
from representation_disentanglement_tpu.training import train as jtrain
from representation_disentanglement_tpu.main_missing import (
    build_model as jax_build_model)
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.multimodal import (
    MultimodalModel, build_model)
from representation_disentanglement_torch.training import train
from representation_disentanglement_torch.weights import (
    from_jax_grads, from_jax_params)

M, B, H, W, CB = 2, 2, 32, 64, 7
SIM_PAIR = np.array([1, 0], np.int32)
CONTRASTS = ["T1", "T1c"]
BASE = dict(contrast_list=CONTRASTS, input_height=H, input_width=W,
            batch_size=B, effective_batch=B, use_pallas=True)
OTHERS = {"ana_dec_act": "softmax", "old": False,
          "softmax_remove_mask": True}
OPTIONS = {
    "full": dict(shared_inp_dec=True, target_model_name="U+SSA+CA",
                 others=dict(OTHERS)),
    "vgg": dict(notshared_impl="vmap", target_model_name="U+SA+CA",
                s_sim_method="perceptual", s_compact_method="vgg",
                others=dict(OTHERS, mod_enc_s=False)),
    "old": dict(target_model_name="U",
                others=dict(OTHERS, old=True, mod_enc_s=False)),
}


def write_random_vgg_npz(path: str, seed: int = 3) -> str:
    """Random VGG16 'features' weights from ``seed`` in the npz format of
    ``models.vgg.dump_torchvision_vgg16`` (chip_smoke.py's, He-scaled)."""
    return chip_smoke.write_vgg_npz(path, seed)


def random_variables(shapes, seed: int):
    """Numpy leaves of the structure ``shapes`` ({"params",
    "batch_stats"} of ShapeDtypeStructs): torch-default-like weights,
    small nonzero biases (a zero bias puts pre-activations at exactly 0,
    where torch's and JAX's LeakyReLU derivatives differ), BatchNorm scales
    and running variances in [0.5, 1.5]."""
    rs = np.random.default_rng(seed)

    def fill(path, a):
        name, shape = path[-1].key, a.shape
        if name == "mean":
            return rs.normal(0.0, 0.1, shape).astype(np.float32)
        if name in ("var", "scale"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("bias", "vgg_pre_bias", "route_bias"):
            return rs.normal(0.0, 0.05, shape).astype(np.float32)
        if name == "route_kernel":
            return rs.uniform(-1.0, 1.0, shape).astype(np.float32)
        fan = int(np.prod(shape[-4:-1])) if len(shape) >= 4 else shape[-2]
        return (rs.uniform(-1.0, 1.0, shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


class OptionPair:
    """The JAX model of configuration ``name`` with random variables, and
    the port with the same weights (``port()``)."""

    def __init__(self, name: str, vgg_npz: str = None, seed: int = 1,
                 **port_kw):
        self.name = name
        cfg = dict(BASE, **OPTIONS[name])
        if name == "vgg":
            cfg["vgg_npz"] = vgg_npz
        self.jcfg = JaxConfig(**cfg, remat=False).derive().validate()
        self.jmodel = jax_build_model(self.jcfg)
        x = jnp.zeros((M, B, H, W, CB))
        mask, mask_img = jnp.ones((B, M)), jnp.zeros((B, H, W))
        shapes = jax.eval_shape(lambda k: self.jmodel.init(
            {"params": k}, x, mask, mask_img, jax.random.PRNGKey(0),
            train=False), jax.random.PRNGKey(1))
        v = random_variables(shapes, seed)
        self.v = {"params": v["params"], "batch_stats": v["batch_stats"]}
        self.cfg = Config(**dict(cfg, **port_kw)).derive().validate()
        self.sd = self.convert(self.v["params"], self.v["batch_stats"])

    def convert(self, params, stats):
        return from_jax_params(
            jax.tree.map(np.asarray, params),
            None if stats is None else jax.tree.map(np.asarray, stats),
            modality_num=M, input_size=(H, W),
            target_model_name=self.jcfg.target_model_name)

    def port(self, cfg=None, sd=None):
        model = build_model(cfg or self.cfg, device="cpu")
        model.load_state_dict(self.sd if sd is None else sd, strict=True)
        return model.train()


def per_modality_sd(sd, m: int = M):
    """A shared-encoder state_dict -> the per-modality one: every encoder
    copy holds the shared weights and running statistics."""
    out = {}
    for k, v in sd.items():
        for root in ("anatomy_encoder_enc_list.0.",
                     "modality_encoder_list.0."):
            if k.startswith(root):
                for i in range(m):
                    out[root[:-2] + f"{i}." + k[len(root):]] = v.clone()
                break
        else:
            out[k] = v
    return out


def batch(m: int = M, seed: int = 11):
    """Slice blocks with a background band; contrast 0 missing in sample
    1."""
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(m, B, H, W, CB)).astype(np.float32)
    x[:, :, :6] = 0.0
    x[0, 1] = 0.0
    mask = np.ones((B, m), np.float32)
    mask[1, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    return {"inputs": x, "mask": mask, "mask_img": mask_img,
            "targets": np.zeros((B, H, W, 1), np.float32)}


def np_(t):
    return t.detach().float().numpy()


def vgg_tmp(tmp_path_factory) -> str:
    d = tmp_path_factory.mktemp("vgg")
    return write_random_vgg_npz(os.path.join(str(d), "vgg16_random.npz"))


def two_threads():
    """Two intra-op threads for torch (a module fixture of each file, as
    in tests/test_torch_train_configs.py): the workers of a parallel test
    run share the cores, and torch's thread pool slows many times over
    when they are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def z_is_the_mean():
    """Both sides take z = the encoder mean (a module fixture of the step
    files, so that it holds for their module-scoped JAX steps)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "sample_z", lambda self, rng, m, lv: m)
        mp.setattr(MultimodalModel, "sample_z", lambda self, gen, m, lv: m)
        yield


def jax_step(pair, data, vgg_ctx=None):
    """(losses, gradients as port-named tensors) of one JAX step."""
    jb = {k: jnp.asarray(v) for k, v in data.items()}

    def loss(params):
        out, _ = pair.jmodel.apply(
            {"params": params, "batch_stats": pair.v["batch_stats"]},
            jb["inputs"], jb["mask"], jb["mask_img"], jax.random.PRNGKey(3),
            train=True, compute_y=True, latent_cycle=True,
            mutable=["batch_stats"])
        ctx = None if vgg_ctx is None else jtrain.make_vgg_ctx(params,
                                                               vgg_ctx)
        l = jtrain.assemble_losses(pair.jcfg, jb, out,
                                   jnp.asarray(SIM_PAIR), vgg_ctx=ctx)
        return l["all"], l

    (_, jl), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        pair.v["params"])
    grads = from_jax_grads(jax.tree.map(np.asarray, jg), modality_num=M,
                           input_size=(H, W),
                           target_model_name=pair.jcfg.target_model_name)
    return {k: float(v) for k, v in jl.items()}, grads


def port_step(model, cfg, data):
    mb = train.prepare_batch(data, "cpu", cfg)
    l = train.loss_fn(model, cfg, mb, torch.Generator().manual_seed(0),
                      SIM_PAIR, True)
    l["all"].backward()
    return ({k: float(v.detach()) for k, v in l.items()},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()})


def check_losses(got, want):
    for k in train.LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def check_grad(name, got, want):
    g = want.numpy()
    bound = 1e-3 * float(np.abs(g).max()) + 2e-5
    assert got.shape == want.shape, name
    assert float(np.abs(np_(got) - g).max()) <= bound, name
