"""Per-sample CondConv, ``cond_mode`` and the z-conditioned generator of
the port against the JAX package on the CPU:

- ``ops/conv.percase_conv2d`` (one grouped conv) against JAX's (a vmap
  over a conv), with a shared and a per-sample bias;
- ``MaybeCondConv`` routed per sample ([G, B, emb] types, and [B, emb]
  types on one group, JAX's 4D-x call) and per group ([G] labels and
  [G, emb] vectors) in both ``cond_mode``s, against JAX's module with the
  same weights; 'sum_experts' against 'grouped' on each side;
- ``GANShortGeneratorZCond`` (every conv routed on each sample's z, two
  groups with their own BatchNorm statistics) in eval and train mode and
  its gradient leaf by leaf;
- ``cond_mode`` from a YAML through ``load_config`` and the run of
  ``main_missing`` (its model's CondConvs), and the refusal of another
  value.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.models.layers import (
    MaybeCondConv as JaxCondConv)
from representation_disentanglement_tpu.models.zcond_generator import (
    GANShortGeneratorZCond as JaxZCond)
from representation_disentanglement_tpu.ops.conv import (
    percase_conv2d as jax_percase)
from representation_disentanglement_torch import config, main_missing
from representation_disentanglement_torch.models.layers import (
    MaybeCondConv, set_cond_mode)
from representation_disentanglement_torch.models.zcond_generator import (
    GANShortGeneratorZCond)
from representation_disentanglement_torch.ops.conv import percase_conv2d
from representation_disentanglement_torch.weights import from_jax_legacy
import torch_legacy_common as C

few_threads = pytest.fixture(scope="module", autouse=True)(C.few_threads)


@pytest.mark.parametrize("stride,pad,bias_rows", [(1, 1, 0), (2, 1, 3)])
def test_percase_conv2d_matches_jax(stride, pad, bias_rows):
    rs = np.random.default_rng(0)
    x = rs.standard_normal((3, 5, 12, 10)).astype(np.float32)
    w = rs.standard_normal((3, 4, 5, 3, 3)).astype(np.float32)
    b = rs.standard_normal((bias_rows, 4) if bias_rows else (4,)).astype(
        np.float32)
    want = jax_percase(jnp.asarray(C.nhwc(x)),
                       jnp.asarray(np.transpose(w, (0, 3, 4, 2, 1))),
                       jnp.asarray(b), stride, pad)
    got = percase_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), stride, pad)
    C.assert_close(got.numpy(), C.nchw(want), "percase_conv2d",
                   rel=1e-6, atol=1e-5)
    # sample i through its own kernel
    for i in range(3):
        one = torch.nn.functional.conv2d(
            torch.from_numpy(x[i:i + 1]), torch.from_numpy(w[i]),
            torch.from_numpy(b[i] if bias_rows else b), stride, pad)
        torch.testing.assert_close(got[i:i + 1], one, rtol=1e-5, atol=1e-5)


def _cond_pair(mode, emb, seed=2):
    jm = JaxCondConv(6, 3, 2, 1, is_cond=True, embeddings=emb,
                     cond_mode=mode)
    tm = MaybeCondConv(5, 6, 3, 2, 1, gen=torch.Generator().manual_seed(0),
                       is_cond=True, embeddings=emb, cond_mode=mode)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((2, 3, 16, 16, 5)), jnp.zeros((2, 3, emb))),
        jax.random.PRNGKey(0))
    v = C.random_variables(shapes, seed)
    tm.load_state_dict(from_jax_legacy(v["params"], None, "zcond"),
                       strict=True)
    return jm, tm, v


@pytest.mark.parametrize("mode", ["grouped", "sum_experts"])
def test_maybe_cond_conv_routings_match_jax(mode):
    rs = np.random.default_rng(3)
    g, b, emb = 2, 3, 4
    x = rs.standard_normal((g, b, 5, 16, 16)).astype(np.float32)
    jm, tm, v = _cond_pair(mode, emb)
    xj = jnp.asarray(np.moveaxis(x, 2, -1))              # [G, B, H, W, C]
    xt = torch.from_numpy(x.reshape(g * b, 5, 16, 16))
    cases = {
        "per-sample [G, B, emb]": rs.standard_normal((g, b, emb)),
        "per-group [G, emb]": rs.standard_normal((g, emb)),
        "per-group labels [G]": np.array([1.0, 2.0]),
    }
    for what, t in cases.items():
        t = t.astype(np.float32)
        want = np.asarray(jm.apply(v, xj, jnp.asarray(t)))
        want = np.moveaxis(want, -1, 2).reshape(g * b, 6, 8, 8)
        got = tm(xt, torch.from_numpy(t))
        C.assert_close(got.detach().numpy(), want, f"{mode} {what}",
                       rel=1e-5, atol=1e-5)
    # JAX's 4D-x call with [B, emb] types: one group, routed per sample
    t = rs.standard_normal((b, emb)).astype(np.float32)
    want = np.asarray(jm.apply(v, xj[0], jnp.asarray(t)))
    got = tm(xt[:b], torch.from_numpy(t))
    C.assert_close(got.detach().numpy(), C.nchw(want), f"{mode} 4D x",
                   rel=1e-5, atol=1e-5)


def test_sum_experts_equals_grouped_on_both_sides():
    rs = np.random.default_rng(4)
    x = rs.standard_normal((2, 3, 5, 16, 16)).astype(np.float32)
    t = np.array([1.0, 2.0], np.float32)
    jouts, touts = [], []
    for mode in ("grouped", "sum_experts"):
        jm, tm, v = _cond_pair(mode, 1)
        jouts.append(np.asarray(jm.apply(v, jnp.asarray(
            np.moveaxis(x, 2, -1)), jnp.asarray(t))))
        touts.append(tm(torch.from_numpy(x.reshape(6, 5, 16, 16)),
                        torch.from_numpy(t)).detach().numpy())
    C.assert_close(jouts[1], jouts[0], "JAX sum_experts", 1e-5, 1e-5)
    C.assert_close(touts[1], touts[0], "port sum_experts", 1e-5, 1e-5)
    assert not np.array_equal(touts[1], touts[0])      # another order
    with pytest.raises(ValueError, match="cond_mode"):
        set_cond_mode(MaybeCondConv(1, 1, 1, gen=torch.Generator(),
                                    is_cond=True), "per_sample")


def _zcond_pair():
    g, b, zs = 2, 2, 16
    x = C.seeded((g, b, 3, 32, 64), 5)
    z = C.seeded((g, b, zs), 6)
    jm = JaxZCond(out_num_ch=1, first_num_ch=4, z_size=zs,
                  output_activation="no")
    tm = GANShortGeneratorZCond(3, 1, 4, zs, output_activation="no",
                                device="cpu")
    return C.LegacyPair(
        jm, tm, "zcond",
        (jnp.asarray(np.moveaxis(x, 2, -1)), jnp.asarray(z)),
        (torch.from_numpy(x.reshape(g * b, 3, 32, 64)),
         torch.from_numpy(z)))


def test_zcond_generator_parity_and_grads():
    p = _zcond_pair()
    p.check("zcond")
    # the biases of the CondConvs that a train-mode BatchNorm follows
    p.check_grads("zcond", cancelled=r"(down|up)_\d\.conv\.bias$")
    # unknown output activations fall back to softplus, as JAX's
    assert GANShortGeneratorZCond(3, 1, 4, output_activation="relu",
                                  device="cpu").out_act == "softplus"


class _Stop(Exception):
    pass


def test_cond_mode_from_yaml_reaches_the_run(tmp_path, monkeypatch):
    yaml_path = tmp_path / "config.yaml"
    yaml_path.write_text(
        "contrast_list: [T1, T2]\ninput_height: 32\ninput_width: 64\n"
        f"data_path: {tmp_path}/\ncond_mode: sum_experts\n")
    cfg = config.load_config(str(yaml_path))
    assert cfg.cond_mode == "sum_experts"
    built = []

    def build(cfg, device=None):
        built.append(real(cfg, device=device))
        return built[-1]

    def stop(*a, **k):
        raise _Stop

    real = main_missing.build_model
    monkeypatch.setattr(main_missing, "build_model", build)
    monkeypatch.setattr(main_missing, "make_loaders", stop)
    with pytest.raises(_Stop):
        main_missing.main([str(yaml_path), "--ckpt-root",
                           str(tmp_path / "ckpt")], device="cpu")
    convs = [m for m in built[0].modules() if isinstance(m, MaybeCondConv)]
    assert convs and {m.cond_mode for m in convs} == {"sum_experts"}
    yaml_path.write_text("cond_mode: per_sample\n")
    with pytest.raises(ValueError, match="cond_mode"):
        config.load_config(str(yaml_path)).validate()
    assert os.path.isdir(tmp_path / "ckpt")
