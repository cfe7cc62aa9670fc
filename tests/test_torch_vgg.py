"""The VGG similarity paths against the JAX package, on the CPU with the same
random VGG16 weights (the pretrained ones are not in the repository; parity
does not need them, as tests/test_vgg_perceptual.py argues).

Both sides read one npz written from a seed in the JAX package's format
(tests/torch_options_common.py ``write_random_vgg_npz``), and share a random
``vgg_pre`` projection.  Checked: the feature taps of ``vgg16_features``
(torchvision's slot counting), ``compact_s_vgg`` (224x224 padding, the
7x7 average pool), ``perceptual_similarity``, ``similarity_s_loss`` with
``sim_method='perceptual'`` and with the VGG compact key, and
``bank_keys`` with the VGG key; ``Config.validate`` without an npz.

Tolerance: relative, |port - JAX| <= 1e-4 max|JAX| per output (measured
at most 9.2e-6, on the compact key and the losses; 3.0e-6 on the taps:
both sides sum the same f32 convolutions in other orders through up to
13 layers).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu import losses as JL
from representation_disentanglement_tpu.models import vgg as jvgg
from representation_disentanglement_torch import losses as L
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models import vgg
from representation_disentanglement_torch.training.evaluate import bank_keys
import torch_options_common as C

two_threads = pytest.fixture(scope="module", autouse=True)(C.two_threads)
REL = 1e-4
CS = 4


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(npz path, JAX vgg_ctx, port vgg_ctx) with one random vgg_pre."""
    path = C.vgg_tmp(tmp_path_factory)
    params = vgg.load_vgg_npz(path)
    rs = np.random.default_rng(5)
    pre_k = rs.uniform(-0.5, 0.5, (3, 3, CS, 3)).astype(np.float32)
    pre_b = rs.normal(0.0, 0.05, 3).astype(np.float32)
    jctx = {"pre_kernel": jnp.asarray(pre_k), "pre_bias": jnp.asarray(pre_b),
            "vgg_params": {k: jnp.asarray(v) for k, v in params.items()}}
    ctx = {"pre_weight": torch.from_numpy(pre_k.transpose(3, 2, 0, 1).copy()),
           "pre_bias": torch.from_numpy(pre_b),
           "vgg_params": vgg.vgg_constants(params, "cpu")}
    return path, jctx, ctx


@pytest.fixture(scope="module")
def codes():
    """Anatomy codes s [M, B, H, W, Cs] and a mask with one absent
    sample."""
    rs = np.random.default_rng(23)
    s = rs.dirichlet(np.ones(CS), size=(C.M, C.B, C.H, C.W)).astype(
        np.float32)
    mask = np.ones((C.B, C.M), np.float32)
    return s, mask


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    bound = REL * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= bound, what


def test_feature_taps_match_jax(weights):
    """Every tap the losses read, and one in the middle of a stage, on a
    64x96 RGB batch."""
    _, jctx, ctx = weights
    rs = np.random.default_rng(29)
    x = rs.normal(size=(C.B, 64, 96, 3)).astype(np.float32)
    taps = (0, 3, 5, 10, 17, 21, 24, 31)
    want = jvgg.vgg16_features(jnp.asarray(x), jctx["vgg_params"], taps)
    got = vgg.vgg16_features(torch.from_numpy(x).permute(0, 3, 1, 2),
                             ctx["vgg_params"], taps)
    for t, g, w in zip(taps, got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w, f"tap {t}")


def test_compact_and_perceptual_match_jax(weights, codes):
    _, jctx, ctx = weights
    s = codes[0][0]                                       # [B, H, W, Cs]
    sn = torch.from_numpy(s).permute(0, 3, 1, 2)
    pre = (jctx["pre_kernel"], jctx["pre_bias"], jctx["vgg_params"])
    tpre = (ctx["pre_weight"], ctx["pre_bias"], ctx["vgg_params"])
    with torch.no_grad():
        _close(vgg.compact_s_vgg(sn, *tpre).numpy(),
               jvgg.compact_s_vgg(jnp.asarray(s), *pre), "compact_s_vgg")
        s2 = codes[0][1]
        _close(vgg.perceptual_similarity(
            sn, torch.from_numpy(s2).permute(0, 3, 1, 2), *tpre).numpy(),
            jvgg.perceptual_similarity(jnp.asarray(s), jnp.asarray(s2),
                                       *pre), "perceptual_similarity")


@pytest.mark.parametrize("method", ["perceptual", "vgg_compact"])
def test_similarity_s_loss_matches_jax(weights, codes, method):
    _, jctx, ctx = weights
    s, mask = codes
    kw = dict(sim_method="perceptual") if method == "perceptual" else \
        dict(sim_method="cosine", compact_method="vgg")
    pair = np.array([1, 0], np.int32)
    want = JL.similarity_s_loss(jnp.asarray(s), jnp.asarray(mask),
                                jnp.asarray(pair), vgg_ctx=jctx, **kw)
    with torch.no_grad():
        got = L.similarity_s_loss(torch.from_numpy(s), torch.from_numpy(mask),
                                  pair, vgg_ctx=ctx, **kw)
    _close(got.numpy(), want, method)
    assert float(got) != 0.0
    # an empty pair mask gives exactly 0, as in the reference
    none = np.zeros_like(mask)
    with torch.no_grad():
        got0 = L.similarity_s_loss(torch.from_numpy(s),
                                   torch.from_numpy(none), pair, vgg_ctx=ctx,
                                   **kw)
    assert float(got0) == 0.0


def test_bank_keys_with_the_vgg_key_match_jax(weights, codes, monkeypatch):
    """``bank_keys`` over a bank s_list [N, M, Cs, H, W], in chunks of two
    rows (``VGG_KEY_ROWS`` patched), against JAX's compact_s."""
    _, jctx, ctx = weights
    from representation_disentanglement_torch.training import evaluate
    monkeypatch.setattr(evaluate, "VGG_KEY_ROWS", 2)
    s = np.concatenate([codes[0][0], codes[0][1][:1]])    # N = 3
    s_list = np.stack([s, s[::-1]], 1).transpose(0, 1, 4, 2, 3)
    got = bank_keys(s_list, 1, "vgg", "cpu", ctx)
    want = JL.compact_s(jnp.asarray(s[::-1]), "vgg", jctx)
    _close(got.numpy(), want, "bank_keys")


def test_validate_needs_the_vgg_npz(weights, tmp_path):
    path = weights[0]
    for kw in (dict(s_sim_method="perceptual"),
               dict(s_compact_method="vgg")):
        with pytest.raises(ValueError, match="vgg_npz"):
            Config(**kw).derive().validate()
        with pytest.raises(ValueError, match="vgg_npz not found"):
            Config(**kw, vgg_npz=os.path.join(str(tmp_path), "no.npz")
                   ).derive().validate()
        Config(**kw, vgg_npz=path).derive().validate()
