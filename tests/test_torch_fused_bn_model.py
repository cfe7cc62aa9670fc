"""The fused-BatchNorm training path and the validation step after it,
against the JAX package, on the CPU with the same weights.

Model, weights and data as tests/test_torch_train_model.py (``Pair``: the
flagship structure at M=2, 32x64, B=2, f32, nonzero biases, non-default
running statistics, z = the encoder mean).  The JAX side takes its fused
path through two process-wide globals, patched with ``monkeypatch`` so that
pytest restores them for the other tests of the worker:
``layers._BN_FUSED_DEFAULT`` (what ``set_bn_fused`` sets; read when a step
is traced, so every JAX function here is jitted after the patch) and
``pallas_bn._FORCE_INTERPRET``, without which the CPU would not take the
fused pass: every train-mode BatchNorm then runs the Pallas kernels K6 and
K7 in interpret mode.  The port takes, in the ``plain`` cases, autograd of
the plain version ``bn_train_fused_plain``, and in the ``function`` cases
its binding ``ops/fused_bn.bn_train_fused``: the custom ops
``rdt::bn_stats`` and ``rdt::bn_norm``, whose CPU implementations are the
plain versions and whose registered backward is the one a CUDA tensor
takes.

Tolerances (tests/test_torch_train_model.py:20-33), with the worst errors
measured on a CPU:
- forward outputs atol 2e-4 (measured 3.0e-5, the train-mode y decodes);
  running statistics rtol 1e-5 / atol 1e-6 (measured 7.2e-7 absolute);
- losses rtol 1e-4 / atol 1e-7 (measured 2.4e-6 relative; latent_z, a
  mean of differences of nearly equal z means, 2.3e-4 relative and 2e-8
  absolute, within the atol); gradients leaf by leaf,
  |port - JAX| <= 1e-3 * max|JAX leaf| + 2e-5;
- one fused-BN train step (the first of its epoch) then ``evaluate`` over
  two batches: every entry of the stat dict rtol 2e-3 / atol 1e-6, the
  tolerance of the f32 trajectory in tests/test_torch_train_step.py
  (measured 1.0e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.main_missing import (
    build_model as jax_build_model)
from representation_disentanglement_tpu.models import layers as jlayers
from representation_disentanglement_tpu.ops import pallas_bn
from representation_disentanglement_tpu.training import evaluate as jeval
from representation_disentanglement_tpu.training import train as jtrain
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models import layers
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.ops import fused_bn
from representation_disentanglement_torch.training import evaluate, optim
from representation_disentanglement_torch.training import train
from representation_disentanglement_torch.weights import (
    from_jax_grads, from_jax_params)
from test_torch_train_model import (
    B, CFG, H, M, W, Pair, SIM_PAIR, _batch, _check_stats, _np,
    nonzero_biases)

# train-mode BatchNorm calls of one forward with compute_y and the latent
# cycle: 8 in the anatomy U-Net, 8 more in its re-encode of the grid
# diagonal, 12 in the U+SA y decoder (down_2..5, the four attention gates'
# W_out BN, up_4..1)
BN_CALLS = 28


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX fused path on; counts the Pallas passes traced."""
    monkeypatch.setattr(jlayers, "_BN_FUSED_DEFAULT", True)
    monkeypatch.setattr(pallas_bn, "_FORCE_INTERPRET", True)
    traced = []
    real = pallas_bn._bn_train_pallas

    def counted(*args, **kw):
        traced.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(pallas_bn, "_bn_train_pallas", counted)
    return traced


@pytest.fixture
def z_is_the_mean(monkeypatch):
    from representation_disentanglement_tpu.models.multimodal import (
        MultimodalModel as JaxModel)
    from representation_disentanglement_torch.models.multimodal import (
        MultimodalModel)
    monkeypatch.setattr(JaxModel, "sample_z", lambda self, rng, m, lv: m)
    monkeypatch.setattr(MultimodalModel, "sample_z",
                        lambda self, gen, m, lv: m)


@pytest.fixture(params=["plain", "function"])
def port_route(request, monkeypatch):
    """Counts the port's fused BatchNorm calls; ``plain``: autograd of the
    plain version ``bn_train_fused_plain``; ``function``: the binding,
    ``bn_train_fused`` through the custom ops ``rdt::bn_stats`` and
    ``rdt::bn_norm`` with the ops' registered backward."""
    calls = []
    real = layers.bn_train_fused

    def plain_route(x, scale, bias, eps, groups):
        calls.append(tuple(x.shape))
        xg = x.reshape((groups, -1) + tuple(x.shape[1:]))
        y, mean, var = fused_bn.bn_train_fused_plain(xg, scale, bias, eps)
        return y.reshape(x.shape), mean.detach(), var.detach()

    def function_route(x, scale, bias, eps, groups):
        calls.append(tuple(x.shape))
        return real(x, scale, bias, eps, groups)

    monkeypatch.setattr(layers, "bn_train_fused",
                        function_route if request.param == "function"
                        else plain_route)
    return calls


def _fused_port(pair):
    port = pair.port()
    port.set_fuse_bn(True)
    return port


def test_fused_forward_matches_jax(pair, jax_fused, port_route,
                                   z_is_the_mean):
    """(a) One train-mode forward with the y decodes and the latent cycle:
    every output and the running statistics; both sides take the fused
    pass at each of the 28 BatchNorm calls."""
    batch = _batch(M)
    fn = jax.jit(lambda v, x, m, mi: pair.jmodel.apply(
        v, x, m, mi, jax.random.PRNGKey(3), train=True, compute_y=True,
        mutable=["batch_stats"]))
    want, muts = fn(pair.v, batch["inputs"], batch["mask"],
                    batch["mask_img"])
    assert len(jax_fused) == BN_CALLS
    port = _fused_port(pair)
    with torch.no_grad():
        got = port(*(torch.from_numpy(batch[k]) for k in
                     ("inputs", "mask", "mask_img")),
                   torch.Generator().manual_seed(0), compute_y=True)
    assert len(port_route) == BN_CALLS
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=2e-4, err_msg=k)
    _check_stats(port, pair.stats_sd(muts["batch_stats"]))


def test_fused_step_gradients_match_jax(pair, jax_fused, port_route,
                                        z_is_the_mean):
    """(b) The loss terms and the gradient of every parameter for one step
    through the fused BatchNorm (JAX: its custom VJP; the port: autograd
    of the plain version, or the ops' registered backward)."""
    batch = _batch(M)

    def jloss(params):
        out, _ = pair.jmodel.apply(
            {"params": params, "batch_stats": pair.v["batch_stats"]},
            batch["inputs"], batch["mask"], batch["mask_img"],
            jax.random.PRNGKey(3), train=True, compute_y=True,
            latent_cycle=True, mutable=["batch_stats"])
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        l = jtrain.assemble_losses(pair.jcfg, jb, out, jnp.asarray(SIM_PAIR))
        return l["all"], l

    (_, jl), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        pair.v["params"])
    assert len(jax_fused) == BN_CALLS
    want = from_jax_grads(jax.tree.map(np.asarray, jg), modality_num=M,
                          input_size=(H, W))
    port = _fused_port(pair)
    mb = train.prepare_batch(batch, "cpu", pair.cfg)
    l = train.loss_fn(port, pair.cfg, mb, torch.Generator().manual_seed(0),
                      SIM_PAIR, compute_y=True)
    l["all"].backward()
    assert len(port_route) == BN_CALLS
    for k in train.LOSS_KEYS:
        np.testing.assert_allclose(float(l[k].detach()), float(jl[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    params = dict(port.named_parameters())
    assert set(params) == set(want)
    for name, g in want.items():
        got = params[name].grad
        got = np.zeros(g.shape, np.float32) if got is None else _np(got)
        bound = 1e-3 * float(np.abs(g.numpy()).max()) + 2e-5
        assert np.abs(got - g.numpy()).max() <= bound, name


def _eval_batches():
    """Two validation batches, every contrast present (an absent one has an
    empty ground truth, whose PSNR is -inf by the reference's rule)."""
    rs = np.random.default_rng(12)
    batches = []
    for band in (slice(0, 6), slice(H - 5, H)):
        x = rs.normal(size=(M, B, H, W, 7)).astype(np.float32)
        x[:, :, band] = 0.0
        batches.append({"inputs": x, "mask": np.ones((B, M), np.float32),
                        "mask_img": (x[1, :, :, :, 0] == 0).astype(
                            np.float32),
                        "targets": np.zeros((B, H, W, 1), np.float32)})
    return batches


def test_fused_train_step_then_validation_matches_jax(jax_fused,
                                                      z_is_the_mean,
                                                      tmp_path):
    """(c) The slice as a whole: one fused-BN Adam step, the first of its
    epoch (so the y decoder's BatchNorms take the fused pass too), then
    ``evaluate`` over two batches with the running statistics that step
    wrote.  Compared: the running statistics after the step and every
    entry of the validation stat dict (11 losses, ssim, psnr, rmse)."""
    jcfg = JaxConfig(**CFG, remat=False, fuse_bn=True,
                     ckpt_path=str(tmp_path)).derive().validate()
    jmodel = jax_build_model(jcfg)
    batch = _batch(M)
    sample = {k: jnp.asarray(v) for k, v in batch.items()}
    state, txs = jtrain.create_train_state(jmodel, jcfg,
                                           jax.random.PRNGKey(1), sample)
    state = state._replace(params=nonzero_biases(
        state.params, np.random.default_rng(7)))
    sd = from_jax_params(jax.tree.map(np.asarray, state.params),
                         jax.tree.map(np.asarray, state.batch_stats),
                         modality_num=M, input_size=(H, W))
    jstep, _ = jtrain.make_train_step(jmodel, jcfg, txs, donate=False)
    pairs = SIM_PAIR[None]
    stacked = {k: jnp.asarray(v)[None] for k, v in batch.items()}
    state, _ = jstep(state, stacked, jax.random.split(
        jax.random.PRNGKey(0), 1), jnp.asarray(pairs), jnp.asarray(pairs),
        jnp.float32(jcfg.lr), first_of_epoch=True)
    assert len(jax_fused) == BN_CALLS
    want = jeval.evaluate(jmodel, state.params, state.batch_stats, jcfg,
                          _eval_batches())

    cfg = Config(**CFG, fuse_bn=True).derive().validate()
    port = build_model(cfg, device="cpu")
    assert all(m.fused for m in port.modules()
               if isinstance(m, layers.BatchNormTorch))
    port.load_state_dict(sd, strict=True)
    step = train.make_train_step(port, cfg, optim.make_optimizer(
        port.parameters(), cfg))
    step({k: v[None] for k, v in batch.items()},
         torch.Generator().manual_seed(0), pairs, first_of_epoch=True)
    _check_stats(port, from_jax_params(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats), modality_num=M,
        input_size=(H, W)))
    got = evaluate.evaluate(port, cfg, _eval_batches())
    assert list(got) == list(want)
    assert all(np.isfinite(v) for v in got.values())
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=2e-3, atol=1e-6)
