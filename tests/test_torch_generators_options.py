"""The output decoders 'U', 'U+SA+CA' and 'U+SSA+CA' and their attention
gates against the JAX package, on the CPU with the same weights.

Each decoder runs alone on grouped anatomy codes, G = M+1 = 3 groups of
B=2 at 32x64 (the per-modality y decodes and the fused one, as the model
calls it), in train mode (every BatchNorm normalizes each group apart; the
running statistics after it are compared) and in eval mode; each gate on
one grouped input.  The weights are the random ones of
tests/torch_options_common.py, carried by ``weights.from_jax_params``.

Tolerances, with the worst errors measured on a CPU: outputs and attention
maps atol 2e-4 (measured 1.3e-5, the 'U+SA+CA' y in train mode),
running statistics rtol 1e-5 / atol 1e-6 (measured 4.8e-7 absolute).
"""

import jax
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.models.attention import (
    ChannelAttentionLayer as JaxCA, SpatialAttentionLayer as JaxSA,
    SymmetryGateResidualSpatialAttentionLayer as JaxSSA)
from representation_disentanglement_tpu.models.generators import (
    make_output_decoder as jax_output_decoder)
from representation_disentanglement_torch.models.attention import (
    ChannelAttentionLayer, SpatialAttentionLayer,
    SymmetryGateResidualSpatialAttentionLayer)
from representation_disentanglement_torch.models.generators import (
    make_output_decoder)
import torch_options_common as C

two_threads = pytest.fixture(scope="module", autouse=True)(C.two_threads)
G, CS = C.M + 1, 4
DECODERS = {"U": "old", "U+SA+CA": "vgg", "U+SSA+CA": "full"}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    npz = C.vgg_tmp(tmp_path_factory)
    return {name: C.OptionPair(cfg, npz) for name, cfg in DECODERS.items()}


@pytest.fixture(scope="module")
def codes():
    rs = np.random.default_rng(17)
    return rs.dirichlet(np.ones(CS), size=(G, C.B, C.H, C.W)).astype(
        np.float32)


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def _nchw(a):
    """[G, B, H, W, C] -> [G*B, C, H, W]."""
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        a.reshape(-1, *a.shape[2:]).transpose(0, 3, 1, 2)))


def _nhwc(t, g=G):
    """[G*B, C, H, W] -> [G, B, H, W, C]."""
    a = C.np_(t).transpose(0, 2, 3, 1)
    return a.reshape(g, -1, *a.shape[1:])


def _close(got, want, what):
    assert got.shape == np.shape(want), what
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4,
                               err_msg=what)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", sorted(DECODERS))
def test_output_decoder_matches_jax(pairs, codes, name, train):
    pair = pairs[name]
    jdec = jax_output_decoder(name, 1, "no")
    jv = {"params": pair.v["params"]["output_decoder"],
          "batch_stats": pair.v["batch_stats"]["output_decoder"]}
    (want, want_alpha), muts = jax.jit(lambda v, x: jdec.apply(
        v, x, train=train, mutable=["batch_stats"]))(jv, codes)
    dec = make_output_decoder(name, CS, 1, "no",
                              gen=torch.Generator().manual_seed(0))
    dec.load_state_dict(_sub(pair.sd, "output_decoder."), strict=True)
    dec.train(train)
    with torch.no_grad():
        y, alpha = dec(_nchw(codes), groups=G)
    _close(_nhwc(y), want, f"{name} y")
    assert set(alpha) == set(want_alpha)
    for k in want_alpha:
        _close(_nhwc(alpha[k]), want_alpha[k], f"{name} {k}")
    if train:
        stats = dict(pair.v["batch_stats"],
                     output_decoder=muts["batch_stats"])
        want_sd = _sub(pair.convert(pair.v["params"], stats),
                       "output_decoder.")
        got = dec.state_dict()
        for k, v in want_sd.items():
            if "running" in k:
                np.testing.assert_allclose(C.np_(got[k]), v.numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("gate", ["SA", "SSA", "CA"])
def test_attention_gates_match_jax(pairs, gate):
    """Level 3 of the channel-attention decoders: x [G*B, 4f, 4, 8], the
    gate g [G*B, 16f, 2, 4] (f = 64), train mode."""
    rs = np.random.default_rng(19)
    x = rs.normal(size=(G, C.B, 4, 8, 256)).astype(np.float32)
    g = rs.normal(size=(G, C.B, 2, 4, 1024)).astype(np.float32)
    pair = pairs["U+SSA+CA" if gate == "SSA" else "U+SA+CA"]
    jname = "att_3_c" if gate == "CA" else "att_3_s"
    jp = pair.v["params"]["output_decoder"][jname]
    sd = _sub(pair.sd, f"output_decoder.{jname}.")
    gen = torch.Generator().manual_seed(0)
    if gate == "CA":
        (want, want_alpha) = JaxCA(4).apply({"params": jp}, x)
        layer = ChannelAttentionLayer(256, 4, gen=gen)
        layer.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got, alpha = layer(_nchw(x))
        _close(_nhwc(got), want, "CA out")
        _close(C.np_(alpha).reshape(G, C.B, -1), want_alpha, "CA alpha")
        return
    jv = {"params": jp, "batch_stats":
          pair.v["batch_stats"]["output_decoder"][jname]}
    jlayer = JaxSSA(256) if gate == "SSA" else JaxSA(256)
    (want, want_alpha), _ = jlayer.apply(jv, x, g, train=True,
                                         mutable=["batch_stats"])
    cls = SymmetryGateResidualSpatialAttentionLayer if gate == "SSA" \
        else SpatialAttentionLayer
    layer = cls(256, 1024, 256, gen=gen).train()
    layer.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got, alpha = layer(_nchw(x), _nchw(g), G)
    _close(_nhwc(got), want, f"{gate} out")
    _close(_nhwc(alpha), want_alpha, f"{gate} alpha")
