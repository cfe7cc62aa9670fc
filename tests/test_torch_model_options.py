"""The port's forward and ``synthesize`` in the 2D model options against the
JAX package, on the CPU with the same weights (tests/torch_options_common.py
gives the configurations and the weights).

- ``full`` (SPADEFull, ``mod_enc_s``, 'U+SSA+CA'), ``vgg`` (the 'vmap'
  decoder halves, 'U+SA+CA', ``vgg_pre``) and ``old`` (non-conditional
  convolutions with SPADEFull, 'U'): the train-mode forward (every output
  key, the y decodes and the latent cycle included) and the running
  statistics it leaves, and the eval-mode ``synthesize``.  Under 'vmap'
  JAX's ``synthesize`` decodes the whole grid and takes row ``source``;
  the port decodes only that row.
- Per-modality encoders, which the JAX package cannot run (see
  tests/torch_options_common.py): the port with M copies of the shared
  weights against the JAX model with shared encoders (the forward is the
  same function: each modality's BatchNorms normalize that modality alone
  either way), with the fused BatchNorm on the port's side; and the port
  with distinct weights per modality, read from stacked (``nn.vmap``)
  trees, against JAX's ``AnatomyEncoderEnc`` and ``ModalityEncoder``
  applied to one modality each, running statistics included.

Both sides take z = the encoder mean.  Tolerances (those of
tests/test_torch_train_model.py), with the worst errors measured on a CPU:
forward outputs atol 2e-4 (measured 4.0e-5, on the train-mode fused y
decode; 3.0e-5 in the per-modality model, 4.8e-6 in ``synthesize``);
running statistics rtol 1e-5 / atol 1e-6 (measured 1.8e-6 absolute, on a
running variance near 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.models.anatomy import (
    AnatomyEncoderEnc as JaxAnatomyEnc, anatomy_activation)
from representation_disentanglement_tpu.models.modality import (
    ModalityEncoder as JaxModalityEncoder)
from representation_disentanglement_tpu.models.multimodal import (
    MultimodalModel as JaxModel)
from representation_disentanglement_torch.models.multimodal import (
    MultimodalModel)
import torch_options_common as C

two_threads = pytest.fixture(scope="module", autouse=True)(C.two_threads)
KEYS = ("inputs", "mask", "mask_img")


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    return C.vgg_tmp(tmp_path_factory)


@pytest.fixture(scope="module")
def pairs():
    """The configurations' pairs, made when a test first needs one."""
    return {}


def _pair(pairs, name, vgg_npz):
    if name not in pairs:
        pairs[name] = C.OptionPair(name, vgg_npz)
    return pairs[name]


@pytest.fixture(scope="module")
def data():
    return C.batch()


@pytest.fixture(autouse=True)
def z_is_the_mean(monkeypatch):
    monkeypatch.setattr(JaxModel, "sample_z", lambda self, rng, m, lv: m)
    monkeypatch.setattr(MultimodalModel, "sample_z",
                        lambda self, gen, m, lv: m)


_JAX_OUT = {}


def _jax_outputs(pair, data):
    """(train forward, its batch_stats, eval synthesize from source 1) of
    the JAX model, one compile per configuration."""
    if pair.name in _JAX_OUT:
        return _JAX_OUT[pair.name]
    jm = pair.jmodel

    def fn(v, x, m, mi):
        out, muts = jm.apply(v, x, m, mi, jax.random.PRNGKey(3), train=True,
                             mutable=["batch_stats"])
        syn = jm.apply(v, x, m, mi, method=jm.synthesize, source=1)
        return out, muts["batch_stats"], syn

    with jax.default_matmul_precision("highest"):
        res = jax.jit(fn)(pair.v, *(data[k] for k in KEYS))
    _JAX_OUT[pair.name] = jax.tree.map(np.asarray, res)
    return _JAX_OUT[pair.name]


def _check_outputs(got, want, atol=2e-4):
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(C.np_(got[k]), want[k], atol=atol,
                                   err_msg=k)


def _check_stats(model, want_sd):
    got = model.state_dict()
    for k, v in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(C.np_(got[k]), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _port_forward(model, data):
    with torch.no_grad():
        return model(*(torch.from_numpy(data[k]) for k in KEYS),
                     torch.Generator().manual_seed(0))


def _port_synthesize(model, data):
    with torch.no_grad():
        return model.eval().synthesize(
            *(torch.from_numpy(data[k]) for k in KEYS), source=1)


@pytest.mark.parametrize("name", ["full", "vgg", "old"])
def test_train_forward_matches_jax(pairs, vgg_npz, data, name):
    """Every output key of the train-mode forward, and the running
    statistics it leaves behind."""
    pair = _pair(pairs, name, vgg_npz)
    want, stats, _ = _jax_outputs(pair, data)
    port = pair.port()
    _check_outputs(_port_forward(port, data), want)
    _check_stats(port, pair.convert(pair.v["params"], stats))


@pytest.mark.parametrize("name", ["full", "vgg", "old"])
def test_synthesize_matches_jax(pairs, vgg_npz, data, name):
    """Eval-mode ``synthesize`` from source 1: the M decodes and the fused
    y (under 'vmap' against JAX's grid row)."""
    pair = _pair(pairs, name, vgg_npz)
    _, _, (want_x, want_y) = _jax_outputs(pair, data)
    x_hat, y = _port_synthesize(pair.port(), data)
    _check_outputs({"x_hat": x_hat, "y": y}, {"x_hat": want_x, "y": want_y})


def test_per_modality_model_matches_shared_jax(pairs, vgg_npz, data):
    """Per-modality encoders holding copies of the shared weights compute
    the shared model's forward and ``synthesize``; the fused BatchNorm
    (``bn_train_fused`` at G = 1 in the encoders) on the port's side."""
    pair = _pair(pairs, "full", vgg_npz)
    want, _, (want_x, want_y) = _jax_outputs(pair, data)
    cfg = C.Config(**dict(C.BASE, **C.OPTIONS["full"], shared_ana_enc=False,
                          shared_mod_enc=False, fuse_bn=True)).derive()
    sd = C.per_modality_sd(pair.sd)
    port = pair.port(cfg, sd)
    assert len(port.anatomy_encoder_enc_list) == C.M
    assert len(port.modality_encoder_list) == C.M
    _check_outputs(_port_forward(port, data), want)
    # the train forward moved each copy's running statistics once, JAX's
    # shared ones M times: synthesize from the loaded statistics
    x_hat, y = _port_synthesize(pair.port(cfg, sd), data)
    _check_outputs({"x_hat": x_hat, "y": y}, {"x_hat": want_x, "y": want_y})


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs, 0), *trees)


def test_per_modality_encoders_match_jax_modules(pairs, vgg_npz, data):
    """Distinct weights per modality, converted from stacked trees: the
    anatomy codes and z of the port's per-modality model against JAX's
    ``AnatomyEncoderEnc`` (G = 1 BatchNorms) and ``ModalityEncoder``
    (``use_s``) applied to one modality each, in train mode with the
    running statistics after it, and in eval mode."""
    pair = _pair(pairs, "full", vgg_npz)
    params, stats = pair.v["params"], pair.v["batch_stats"]
    rs = np.random.default_rng(21)
    jitter = lambda t: jax.tree.map(
        lambda a: (a * rs.uniform(0.8, 1.2, a.shape)).astype(np.float32), t)
    enc_p = [jitter(params["anatomy_encoder_enc"]) for _ in range(C.M)]
    enc_s = [jitter(stats["anatomy_encoder_enc"]) for _ in range(C.M)]
    mod_p = [jitter(params["modality_encoder"]) for _ in range(C.M)]
    sp = dict(params, anatomy_encoder_enc=_stack(enc_p),
              modality_encoder=_stack(mod_p))
    ss = dict(stats, anatomy_encoder_enc=_stack(enc_s))
    cfg = C.Config(**dict(C.BASE, **C.OPTIONS["full"], shared_ana_enc=False,
                          shared_mod_enc=False)).derive()
    port = pair.port(cfg, pair.convert(sp, ss))
    x, mask_img = data["inputs"], data["mask_img"]
    types = jnp.arange(1, C.M + 1, dtype=jnp.float32)
    enc = JaxAnatomyEnc(32, True, False)
    menc = JaxModalityEncoder(first_num_ch=16, z_size=16, use_s=True,
                              is_cond=True)
    jm = pair.jmodel

    def jax_codes(train):
        feats, new_stats = [], []
        for m in range(C.M):
            f, muts = enc.apply({"params": enc_p[m], "batch_stats": enc_s[m]},
                                x[m][None], types[m:m + 1], train=train,
                                mutable=["batch_stats"])
            feats.append(f)
            new_stats.append(muts["batch_stats"])
        feats = tuple(jnp.concatenate(f, 0) for f in zip(*feats))
        logits, _ = jm.apply(
            {"params": params, "batch_stats": stats}, feats, types,
            method=lambda mdl, f, t: mdl.anatomy_encoder_dec(f, t,
                                                             train=train),
            mutable=["batch_stats"])
        s = anatomy_activation(logits, mask_img, "softmax", True)
        z = [menc.apply({"params": mod_p[m]}, x[m][None], s[m][None],
                        types[m:m + 1])[0][0] for m in range(C.M)]
        return s, jnp.stack(z), new_stats

    for train in (False, True):
        want_s, want_z, new_stats = jax.jit(lambda: jax_codes(train))()
        port.train(train)
        with torch.no_grad():
            xt = torch.from_numpy(x)
            s = port.encode_anatomy(xt, torch.from_numpy(mask_img))
            z, _ = port.encode_modality(xt, s)
        _check_outputs({"s": s, "z": z}, {"s": np.asarray(want_s),
                                          "z": np.asarray(want_z)})
        if train:
            want_sd = pair.convert(
                sp, dict(stats, anatomy_encoder_enc=_stack(new_stats)))
            _check_stats(port, {k: v for k, v in want_sd.items()
                                if k.startswith("anatomy_encoder_enc")})
