"""The port's training forward and the gradients of one step against the
JAX package, on the CPU with the same weights.

The JAX model is the flagship structure (split SPADE decoder with loop
halves, CondConv, 'U+SA', ``use_pallas=True``, which on the CPU takes the
XLA interior and its custom-VJP backward) at M=2 (one forward case at the
flagship's M=4), 32x64, B=2, f32, with the shipped five losses.  Its
weights and (non-default) BatchNorm running statistics reach the port
through ``weights.from_jax_params``.  Both sides
take z = the encoder mean (``sample_z`` patched, as
tests/test_train_parity_full.py does), so the comparison is deterministic.

The zero-initialized biases (CondConv) get small nonzero values first.  A
zero-filled input times a zero bias puts pre-activations at exactly 0,
where torch's LeakyReLU (the port's, and the reference's) has derivative
0.2 and ``jax.nn.leaky_relu`` has 1; with the biases at zero the two
gradients of the first conv's bias differ by design (measured: 49% of the
leaf's norm), not by a fault of either side.

Tolerances, with what was measured on a CPU:
- forward outputs at M=2 and M=4, and the grid and y decodes: atol 2e-4
  (tests/test_torch_model.py; measured at most 1.2e-4, on the train-mode y
  decodes, whose BatchNorms normalize over two samples; at most 3.6e-6 on
  the other outputs); running statistics after the forward: rtol 1e-5 /
  atol 1e-6 (measured at most 1.0e-6 absolute);
- losses: rtol 1e-4 (measured at most 1.5e-4 relative on latent_z, a mean
  of differences of nearly equal z means; 5e-7 on the others);
- gradients, leaf by leaf over the 308 leaves:
  |port - JAX| <= 1e-3 * max|JAX leaf| + 2e-5.  Measured: at most 4.8e-4
  of the leaf's largest entry on leaves with real gradients; a bias that
  feeds a normalization (BatchNorm in train mode, the SPADE instance norm)
  has an exactly zero gradient, which both sides return as rounding noise
  of up to 5.7e-6.
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
from representation_disentanglement_torch.training import train
from representation_disentanglement_torch.weights import (
    from_jax_grads, from_jax_params)

M, B, H, W, CB = 2, 2, 32, 64, 7
CONTRASTS = ["T1", "T1c", "T2", "T2_FLAIR"]
CFG = dict(contrast_list=CONTRASTS[:M], input_height=H, input_width=W,
           batch_size=B, effective_batch=B, use_pallas=True,
           notshared_impl="loop",
           others={"mod_enc_s": False, "ana_dec_act": "softmax",
                   "old": False, "softmax_remove_mask": True})
SIM_PAIR = np.array([1, 0], np.int32)


def nonzero_biases(params, rs):
    """Every all-zero bias leaf -> small random values (module docstring)."""
    def fix(path, a):
        if path[-1].key == "bias" and not np.any(np.asarray(a)):
            return jnp.asarray(rs.normal(0.0, 0.05, a.shape), jnp.float32)
        return a
    return jax.tree_util.tree_map_with_path(fix, params)


class Pair:
    """The JAX model with its variables; ``port()`` gives the port with the
    same weights and running statistics."""

    def __init__(self, m=M):
        self.m = m
        cfg = dict(CFG, contrast_list=CONTRASTS[:m])
        self.jcfg = JaxConfig(**cfg, remat=False).derive().validate()
        self.jmodel = jax_build_model(self.jcfg)
        x = jnp.zeros((m, B, H, W, CB))
        mask, mask_img = jnp.ones((B, m)), jnp.zeros((B, H, W))
        v = jax.jit(lambda k: self.jmodel.init(
            {"params": k}, x, mask, mask_img, jax.random.PRNGKey(0),
            train=False))(jax.random.PRNGKey(1))
        rs = np.random.default_rng(7)
        v = dict(v, params=nonzero_biases(v["params"], rs))

        def running(path, a):
            if path[-1].key == "mean":
                return rs.normal(0.0, 0.1, a.shape).astype(np.float32)
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)

        stats = jax.tree_util.tree_map_with_path(running, v["batch_stats"])
        self.v = {"params": v["params"], "batch_stats": stats}
        self.cfg = Config(**cfg).derive().validate()
        self.sd = from_jax_params(jax.tree.map(np.asarray, v["params"]),
                                  jax.tree.map(np.asarray, stats),
                                  modality_num=m, input_size=(H, W))

    def port(self):
        model = build_model(self.cfg, device="cpu")
        model.load_state_dict(self.sd, strict=True)
        return model.train()

    def stats_sd(self, batch_stats):
        return from_jax_params(jax.tree.map(np.asarray, self.v["params"]),
                               jax.tree.map(np.asarray, batch_stats),
                               modality_num=self.m, input_size=(H, W))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _batch(m):
    """Slice blocks with a background band; contrast 0 missing in sample 1."""
    rs = np.random.default_rng(11)
    x = rs.normal(size=(m, B, H, W, CB)).astype(np.float32)
    x[:, :, :6] = 0.0
    x[0, 1] = 0.0
    mask = np.ones((B, m), np.float32)
    mask[1, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    return {"inputs": x, "mask": mask, "mask_img": mask_img,
            "targets": np.zeros((B, H, W, 1), np.float32)}


@pytest.fixture(scope="module")
def batch():
    return _batch(M)


@pytest.fixture
def z_is_the_mean(monkeypatch):
    monkeypatch.setattr(JaxModel, "sample_z", lambda self, rng, m, lv: m)
    monkeypatch.setattr(MultimodalModel, "sample_z",
                        lambda self, gen, m, lv: m)


def _np(t):
    return t.detach().float().numpy()


def _jax_forward(pair, batch, compute_y):
    fn = jax.jit(lambda v, x, m, mi: pair.jmodel.apply(
        v, x, m, mi, jax.random.PRNGKey(3), train=True, compute_y=compute_y,
        mutable=["batch_stats"]))
    return fn(pair.v, batch["inputs"], batch["mask"], batch["mask_img"])


def _check_stats(model, want_sd):
    got = model.state_dict()
    for k, v in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(_np(got[k]), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("compute_y", [True, False])
def test_train_forward_matches_jax(pair, batch, z_is_the_mean, compute_y):
    """Every output key of the train-mode forward, and the BatchNorm
    running statistics it leaves behind."""
    _check_forward(pair, batch, compute_y)


def test_train_forward_matches_jax_four_contrasts(z_is_the_mean):
    """The flagship's M=4: a 4x4 decode grid with types t[i, j] = 1+j, five
    output-decoder groups, four not-shared halves."""
    _check_forward(Pair(4), _batch(4), True)


def test_grid_and_y_decodes_match_jax(pair):
    """``decode_inputs_grid`` and ``decode_outputs(per_modality=True)`` in
    eval mode, from the same anatomy codes and z."""
    rs = np.random.default_rng(13)
    s = rs.dirichlet(np.ones(4), size=(M, B, H, W)).astype(np.float32)
    z = rs.normal(size=(M, B, 16)).astype(np.float32)
    mask = np.array([[1, 0], [1, 1]], np.float32)
    fn = jax.jit(lambda v: (
        pair.jmodel.apply(v, s, z, method=pair.jmodel.decode_inputs_grid),
        pair.jmodel.apply(v, s, mask, train=False,
                          method=pair.jmodel.decode_outputs)))
    want_grid, (want_list, want_y) = fn(pair.v)
    port = pair.port().eval()
    with torch.no_grad():
        grid = port.decode_inputs_grid(torch.from_numpy(s),
                                       torch.from_numpy(z))
        y_list, y = port.decode_outputs(torch.from_numpy(s),
                                        torch.from_numpy(mask))
    for got, want in ((grid, want_grid), (y_list, want_list), (y, want_y)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-4)


def _check_forward(pair, batch, compute_y):
    want, muts = _jax_forward(pair, batch, compute_y)
    port = pair.port()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        got = port(*(torch.from_numpy(batch[k]) for k in
                     ("inputs", "mask", "mask_img")), gen,
                   compute_y=compute_y)
    assert set(got) == set(want)
    assert ("y_fake_list" in got) == compute_y
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=2e-4, err_msg=k)
    _check_stats(port, pair.stats_sd(muts["batch_stats"]))
    if not compute_y:
        od = {k: v for k, v in port.state_dict().items()
              if k.startswith("output_decoder") and "running" in k}
        assert all(torch.equal(v, pair.sd[k]) for k, v in od.items())


@pytest.mark.parametrize("compute_y", [True, False])
def test_step_gradients_match_jax_leaf_by_leaf(pair, batch, z_is_the_mean,
                                               compute_y):
    """Loss terms and the gradient of every parameter for one step."""
    jcfg = pair.jcfg

    def jloss(params):
        out, muts = pair.jmodel.apply(
            {"params": params, "batch_stats": pair.v["batch_stats"]},
            batch["inputs"], batch["mask"], batch["mask_img"],
            jax.random.PRNGKey(3), train=True, compute_y=compute_y,
            latent_cycle=True, mutable=["batch_stats"])
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        l = jtrain.assemble_losses(jcfg, jb, out, jnp.asarray(SIM_PAIR))
        return l["all"], l

    (_, jl), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        pair.v["params"])
    want = from_jax_grads(jax.tree.map(np.asarray, jg), modality_num=M,
                          input_size=(H, W))
    port = pair.port()
    mb = train.prepare_batch(batch, "cpu", pair.cfg)
    l = train.loss_fn(port, pair.cfg, mb, torch.Generator().manual_seed(0),
                      SIM_PAIR, compute_y)
    l["all"].backward()
    for k in train.LOSS_KEYS:
        np.testing.assert_allclose(float(l[k].detach()), float(jl[k]),
                                   rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    params = dict(port.named_parameters())
    assert set(params) == set(want)
    for name, g in want.items():
        got = params[name].grad
        got = np.zeros(g.shape, np.float32) if got is None else _np(got)
        bound = 1e-3 * float(np.abs(g.numpy()).max()) + 2e-5
        assert np.abs(got - g.numpy()).max() <= bound, name
        # no shipped loss reaches y, and with z = the mean no loss reaches
        # the log-variance head
        unreached = name.startswith(("output_decoder",
                                     "modality_encoder_list.0.log_var"))
        assert got.any() != unreached, name


def test_unported_training_options_raise(pair, tmp_path):
    """Every 2D option of JAX's build_model is ported: build_model accepts
    SPADEFull (``shared_inp_dec``, ``others.old``), per-modality encoders,
    the 'vmap' halves, ``mod_enc_s`` and the VGG paths (with an npz), and
    the y, KL and adversarial losses and the stage-2 freeze; what still
    raises is a VGG configuration without its npz (``Config.validate``, as
    in JAX) and an unknown output decoder (``from_jax_params``)."""
    from representation_disentanglement_torch.weights import (
        from_jax_params)
    npz = tmp_path / "vgg.npz"
    np.savez(npz, conv0_bias=np.zeros(64, np.float32))
    others = dict(CFG["others"], mod_enc_s=True)
    old = dict(CFG["others"], old=True)
    for kw in ({"shared_inp_dec": True}, {"shared_ana_enc": False},
               {"shared_mod_enc": False}, {"notshared_impl": "vmap"},
               {"others": others}, {"others": old},
               {"s_compact_method": "vgg", "vgg_npz": str(npz)},
               {"s_sim_method": "perceptual", "vgg_npz": str(npz)}):
        cfg = Config(**dict(CFG, **kw)).derive().validate()
        model = build_model(cfg, device="cpu")
        if "others" in kw and kw["others"].get("old"):
            assert not model.anatomy_encoder_dec.up_4.conv.is_cond
            assert len(model.input_decoder_list) == 1
        if "vgg_npz" in kw:
            assert tuple(model.vgg_pre.weight.shape) == (3, 4, 3, 3)
    for kw in ({"s_compact_method": "vgg"}, {"s_sim_method": "perceptual"}):
        with pytest.raises(ValueError, match="vgg_npz"):
            Config(**dict(CFG, **kw)).derive().validate()
    with pytest.raises(ValueError, match="target_model_name"):
        from_jax_params({}, None, modality_num=M, input_size=(H, W),
                        target_model_name="U+XA")
    cfg = Config(**CFG, lambda_adv_s=1.0, lambda_kl=0.1, lambda_recon_y=1.0,
                 out_num_ch=4, is_distri_z=True, continue_train=True,
                 fix_pretrain=True).derive().validate()
    model = build_model(cfg, device="cpu")
    assert model.is_discrim_s and model.is_distri_z
