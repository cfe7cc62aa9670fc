"""The port's serving path against the JAX package, module by module and
as a whole, on the CPU with the same weights.

The JAX model is the flagship structure (split SPADE decoder with loop
halves, CondConv, 'U+SA', ``use_pallas=True``, which on the CPU takes the
plain XLA interior) at M=2, 32x64.  Its weights reach the port through
``weights.from_jax_params``; its BatchNorm running statistics are set to
non-default values first, so eval-mode BN is exercised.

Tolerances: f32 atol 2e-4 (tests/test_parity_model.py).  bf16: relative L2
error at most 5e-2 against the JAX bf16 serve step.  Measured on a CPU:
3.0e-2 for x_hat and 3.1e-3 for y.  That is bf16 noise, not a fault: the
JAX bf16 step is itself 2.3e-2 (x_hat) and 3.0e-3 (y) from the JAX f32 step,
and the port's bf16 step 2.0e-2 and 2.9e-3; the two frameworks round bf16
in different places inside convs, linears and softmax, and the SPADE
instance norms of a random-weight decoder amplify that rounding.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from representation_disentanglement_tpu import serve as jax_serve
from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.main_missing import (
    build_model as jax_build_model)
from representation_disentanglement_torch import serve
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.multimodal import (
    build_model, to_nchw)
from representation_disentanglement_torch.weights import from_jax_params

M, B, H, W, CB = 2, 2, 32, 64, 7
ATOL = 2e-4
BF16_REL_L2 = 5e-2
CFG = dict(contrast_list=["T1", "T1c"], input_height=H, input_width=W,
           batch_size=B, use_pallas=True, notshared_impl="loop",
           others={"mod_enc_s": False, "ana_dec_act": "softmax",
                   "old": False, "softmax_remove_mask": True})


class Pair:
    """The JAX model with its variables, and the port with the same
    weights."""

    def __init__(self):
        self.jcfg = JaxConfig(**CFG, remat=False).derive().validate()
        self.jmodel = jax_build_model(self.jcfg)
        x = jnp.zeros((M, B, H, W, CB))
        mask, mask_img = jnp.ones((B, M)), jnp.zeros((B, H, W))

        def every_half(mod, x, mask, mask_img):
            return [mod.synthesize(x, mask, mask_img, source=i)
                    for i in range(M)]

        v = jax.jit(lambda k: self.jmodel.init(
            k, x, mask, mask_img, method=every_half))(jax.random.PRNGKey(1))
        rs = np.random.default_rng(7)

        def running(path, a):
            if path[-1].key == "mean":
                return rs.normal(0.0, 0.1, a.shape).astype(np.float32)
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)

        stats = jax.tree_util.tree_map_with_path(running, v["batch_stats"])
        self.v = {"params": v["params"], "batch_stats": stats}
        self.cfg = Config(**CFG).derive().validate()
        self.port = build_model(self.cfg, device="cpu")
        self.port.load_state_dict(from_jax_params(
            jax.tree.map(np.asarray, v["params"]),
            jax.tree.map(np.asarray, stats), modality_num=M,
            input_size=(H, W)), strict=True)

    def japply(self, *args, method, **kw):
        fn = jax.jit(lambda v, *a: self.jmodel.apply(v, *a, method=method,
                                                     **kw))
        return fn(self.v, *args)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def batch():
    """Slice blocks with a background band, contrast 0 missing."""
    rs = np.random.default_rng(11)
    x = rs.normal(size=(M, B, H, W, CB)).astype(np.float32)
    x[:, :, :6] = 0.0
    x[0] = 0.0
    mask = np.ones((B, M), np.float32)
    mask[:, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    return x, mask, mask_img


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=atol)


def test_anatomy_encoder_matches_jax(pair, batch):
    x, _, mask_img = batch
    want = pair.japply(x, mask_img, train=False,
                       method=pair.jmodel.encode_anatomy)
    with torch.inference_mode():
        got = pair.port.encode_anatomy(torch.from_numpy(x),
                                       torch.from_numpy(mask_img))
    _close(got, want)


def test_modality_encoder_matches_jax(pair, batch):
    x = batch[0]
    want_mean, want_lv = pair.japply(x, None,
                                     method=pair.jmodel.encode_modality)
    with torch.inference_mode():
        got_mean, got_lv = pair.port.encode_modality(torch.from_numpy(x))
    _close(got_mean, want_mean)
    _close(got_lv, want_lv)


def test_spade_halves_match_jax(pair):
    """SPADEShared then the not-shared half of modality 1, fused interior
    on (``use_pallas``), from the same anatomy codes and z."""
    rs = np.random.default_rng(13)
    s = rs.dirichlet(np.ones(4), size=(M, B, H, W)).astype(np.float32)
    z = rs.normal(size=(M, B, 16)).astype(np.float32)
    types = jnp.arange(1, M + 1, dtype=jnp.float32)

    def halves(mod, s, z, t):
        mid = mod.input_decoder_shared(s, z, t)
        return mid, mod.input_decoder_notshared[1](s, mid, t)

    want_mid, want_out = pair.japply(s, z, types, method=halves)
    port = pair.port
    tt = torch.arange(1, M + 1, dtype=torch.float32)
    sf = to_nchw(torch.from_numpy(s))
    with torch.inference_mode():
        mid = port.input_decoder_list[M](sf, torch.from_numpy(z).view(M * B, -1),
                                         tt)
        out = port.input_decoder_list[1](sf, mid, tt)
    assert port.input_decoder_list[M].sp1.use_pallas
    _close(mid.view(M, B, *mid.shape[1:]).permute(0, 1, 3, 4, 2), want_mid)
    _close(out.view(M, B, *out.shape[1:]).permute(0, 1, 3, 4, 2), want_out)


def test_output_decoder_matches_jax(pair):
    """The fused-y U+SA decode from anatomy codes, one modality masked out
    for one sample."""
    rs = np.random.default_rng(17)
    s = rs.dirichlet(np.ones(4), size=(M, B, H, W)).astype(np.float32)
    mask = np.array([[1, 0], [1, 1]], np.float32)
    want_list, want_y = pair.japply(s, mask, train=False, per_modality=False,
                                    method=pair.jmodel.decode_outputs)
    assert want_list is None
    with torch.inference_mode():
        got_list, got_y = pair.port.decode_outputs(
            torch.from_numpy(s), torch.from_numpy(mask), per_modality=False)
    assert got_list is None
    _close(got_y, want_y)


def test_synthesize_matches_jax(pair, batch):
    """The whole slice: decode both modalities from the anatomy of
    modality 1, with modality 0 zero-filled and masked out."""
    x, mask, mask_img = batch
    want_x, want_y = pair.japply(x, mask, mask_img, source=1,
                                 method=pair.jmodel.synthesize)
    with torch.inference_mode():
        got_x, got_y = pair.port.synthesize(
            torch.from_numpy(x), torch.from_numpy(mask),
            torch.from_numpy(mask_img), source=1)
    assert got_x.shape == (M, B, H, W, CB) and got_y.shape == (B, H, W, 1)
    _close(got_x, want_x)
    _close(got_y, want_y)


def test_synthesize_overrides_match_jax(pair, batch):
    """``z=`` and ``s=`` overrides, ``with_y=False``."""
    x, mask, mask_img = batch
    rs = np.random.default_rng(19)
    s = rs.dirichlet(np.ones(4), size=(M, B, H, W)).astype(np.float32)
    z = rs.normal(size=(M, B, 16)).astype(np.float32)
    want_x, want_y = pair.japply(x, mask, mask_img, source=0, z=z, s=s,
                                 with_y=False, method=pair.jmodel.synthesize)
    assert want_y is None
    with torch.inference_mode():
        got_x, got_y = pair.port.synthesize(
            torch.from_numpy(x), torch.from_numpy(mask),
            torch.from_numpy(mask_img), source=0, z=torch.from_numpy(z),
            s=torch.from_numpy(s), with_y=False)
    assert got_y is None
    _close(got_x, want_x)


def _jax_step(pair, cfg, batch):
    x, mask, mask_img = batch
    step = jax_serve.make_serve_step(pair.jmodel, cfg, source=1)
    return step(pair.v["params"], pair.v["batch_stats"], x, mask, mask_img)


def test_serve_step_f32_matches_jax(pair, batch):
    want_x, want_y = _jax_step(pair, pair.jcfg, batch)
    got_x, got_y = serve.make_serve_step(pair.port, pair.cfg, source=1)(
        *batch)
    assert got_x.dtype == torch.float32 and got_y.dtype == torch.float32
    _close(got_x, want_x)
    _close(got_y, want_y)


def test_serve_step_bf16_matches_jax(pair, batch):
    jcfg = JaxConfig(**CFG, remat=False, compute_dtype="bfloat16").derive()
    cfg = Config(**CFG, compute_dtype="bfloat16").derive()
    want_x, want_y = _jax_step(pair, jcfg, batch)
    got_x, got_y = serve.make_serve_step(pair.port, cfg, source=1)(*batch)
    for got, want in ((got_x, want_x), (got_y, want_y)):
        want = np.asarray(want, np.float32)
        err = np.linalg.norm(_np(got) - want) / np.linalg.norm(want)
        assert err <= BF16_REL_L2, err


def test_serve_requests_applies_the_request_rules(pair):
    """Zero-fill and unmask the missing contrast, take the background mask
    from the source when contrast 0 is missing, pad the tail batch by
    repeating its last row, keep the centre slice."""
    rs = np.random.default_rng(23)
    n = 3                                   # one full batch + a tail of 1
    inputs = rs.normal(size=(M, n, H, W, CB)).astype(np.float32)
    inputs[:, :, :5] = 0.0
    out = serve.serve_requests(pair.port, pair.cfg, inputs, missing=["T1"])
    assert out["source"] == "T1c" and out["steps"] == 2
    assert set(out["x_hat"]) == {"T1", "T1c"}
    step = serve.make_serve_step(pair.port, pair.cfg, source=1)
    x = inputs[:, [2, 2]].copy()
    x[0] = 0.0
    mask = np.array([[0, 1], [0, 1]], np.float32)
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    want_x, want_y = step(x, mask, mask_img)
    np.testing.assert_allclose(out["x_hat"]["T1"][2],
                               _np(want_x[0, 0, :, :, 3]), atol=1e-6)
    np.testing.assert_allclose(out["y"][2], _np(want_y[0, :, :, 0]),
                               atol=1e-6)
    assert out["x_hat"]["T1"].shape == (n, H, W) and out["y"].shape == (n, H, W)
    with pytest.raises(ValueError, match="in missing"):
        serve.serve_requests(pair.port, pair.cfg, inputs, missing=["T1"],
                             source="T1")
