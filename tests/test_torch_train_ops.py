"""The training slice's ops against the JAX package, on the CPU: the SPADE
backward, BatchNorm in train mode, the statistics helpers, pooling, the
shipped losses, the optimizer, clipping and the schedule, and the training
fields of the config.

Tolerances, with what was measured on a CPU:
- backward, plain against the JAX Pallas kernels K3 (slab) and K4 (packed)
  run in interpret mode: f32 atol 1e-5 (measured at most 2.9e-6: the
  kernels' one-pass variance against the plain two-pass one); bf16 and the
  mixed pairings: 2 bf16 ulps of the reference plus 1e-5, since f32
  differences of that size may move a bf16 rounding by one ulp (bf16
  measured exact; the mixed pairings use at most 0.46 of the tolerance);
- backward, plain against torch autograd of ``in_modulate_plain`` in f32:
  atol 1e-5 (measured 4.8e-7);
- BatchNorm train mode: outputs and input gradients atol 1e-5, scale and
  bias gradients rtol/atol 1e-4, running statistics rtol 1e-5 / atol 1e-6
  (measured at most 7.6e-6 absolute, on the input gradient);
- statistics helpers, pooling, losses, clipping: rtol 1e-5 / atol 1e-6
  (measured at most 3.8e-6 relative, the one-pass variance; losses 2.1e-7
  relative; pooling exact);
- Adam after three steps: rtol 1e-5 / atol 1e-7 on parameters of size 1
  (measured 1.9e-7 absolute, 1.3e-6 relative: the two implementations
  order the update's f32 operations differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu import losses as JL
from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.models.layers import (
    BatchNormTorch as JaxBatchNorm)
from representation_disentanglement_tpu.ops import norm as jnorm
from representation_disentanglement_tpu.ops import pool as jpool
from representation_disentanglement_tpu.ops.pallas_kernels import (
    _dispatch, in_modulate as jax_in_modulate)
from representation_disentanglement_tpu.training import optim as joptim
from representation_disentanglement_tpu.training import train as jtrain
from representation_disentanglement_torch import config, losses
from representation_disentanglement_torch.models.layers import BatchNormTorch
from representation_disentanglement_torch.ops import (
    avg_pool, batch_stats, kernels, max_pool, sequential_ema)
from representation_disentanglement_torch.training import optim, train

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def _bf16_tol(want):
    """2 bf16 ulps of |want| plus 1e-5."""
    _, exp = np.frexp(np.maximum(np.abs(want), 2.0 ** -100))
    return 2.0 * np.ldexp(1.0, exp - 8) + 1e-5


# ---- the SPADE backward ---------------------------------------------------

BWD_SHAPES = [((2, 5, 6, 128), "slab"), ((2, 20, 24, 32), "packed")]
DTYPES = {"f32": (torch.float32, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16),
          "bf16-zi/f32-gamma": (torch.bfloat16, torch.float32),
          "f32-zi/bf16-gamma": (torch.float32, torch.bfloat16)}


def _bwd_inputs(shape, zd, gd, seed):
    """NCHW torch tensors zi, gamma, beta, g, rounded once to their dtypes
    so that both sides see the same values."""
    rs = np.random.default_rng(seed)
    mk = lambda off, sc: (off + sc * rs.normal(size=shape)).astype(np.float32)
    arrs = [mk(1.5, 2.0), mk(0.0, 0.5), mk(0.0, 0.5), mk(0.0, 1.0)]
    dts = [zd, gd, gd, zd]
    return [torch.from_numpy(np.moveaxis(a, -1, 1).copy()).to(d)
            for a, d in zip(arrs, dts)]


def _jax(t):
    a = jnp.asarray(np.moveaxis(t.float().numpy(), 1, -1))
    return a.astype(jnp.bfloat16 if t.dtype == torch.bfloat16 else
                    jnp.float32)


@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("shape,kind", BWD_SHAPES)
def test_in_modulate_bwd_plain_matches_pallas_bwd(shape, kind, dtypes):
    """in_modulate_bwd_plain against jax.vjp of the Pallas in_modulate in
    interpret mode, which runs K3 ``_bwd_kernel`` (slab) or K4
    ``_packed_bwd_kernel`` (packed)."""
    zd, gd = DTYPES[dtypes]
    zi, gamma, beta, g = _bwd_inputs(shape, zd, gd, seed=sum(shape))
    jz, jgm, jb, jg = (_jax(t) for t in (zi, gamma, beta, g))
    assert _dispatch(jz) == kind
    _, vjp = jax.vjp(lambda a, b, c: jax_in_modulate(a, b, c, 1e-5, True),
                     jz, jgm, jb)
    want = vjp(jg)
    before = kernels.launch_counts()
    got = kernels.in_modulate_bwd_plain(zi, gamma, g)
    assert kernels.launch_counts() == before
    assert [t.dtype for t in got] == [zd, gd, gd]
    for name, gt, wt in zip(("dz", "dgamma", "dbeta"), got, want):
        gt = gt.float().numpy()
        wt = np.moveaxis(np.asarray(wt, np.float32), -1, 1)
        if gt.dtype == np.float32 and zd == gd == torch.float32:
            np.testing.assert_allclose(gt, wt, atol=1e-5, err_msg=name)
        else:
            err = np.abs(gt - wt)
            assert (err <= _bf16_tol(wt)).all(), (name, float(err.max()))


def test_in_modulate_bwd_plain_matches_autograd():
    """In f32 the plain backward equals torch autograd of the plain
    forward, which is what differentiates ``in_modulate`` on the CPU."""
    zi, gamma, beta, g = _bwd_inputs((2, 9, 11, 8), torch.float32,
                                     torch.float32, seed=5)
    for t in (zi, gamma, beta):
        t.requires_grad_(True)
    out = kernels.in_modulate(zi, gamma, beta)
    want = torch.autograd.grad(out, (zi, gamma, beta), g)
    got = kernels.in_modulate_bwd_plain(zi.detach(), gamma.detach(), g)
    for gt, wt in zip(got, want):
        _close(gt, wt, rtol=0, atol=1e-5)


# ---- normalization helpers and BatchNorm -----------------------------------

def test_batch_stats_and_sequential_ema_match_jax():
    rs = np.random.default_rng(0)
    x = (2.0 + rs.normal(size=(3, 4, 5, 6, 7))).astype(np.float32)  # NHWC
    jm, jv = jnorm.batch_stats(jnp.asarray(x), (1, 2, 3))
    m, v = batch_stats(_t(np.moveaxis(x, -1, 2)), (1, 3, 4))
    _close(m, jm)
    _close(v, jv)
    run = rs.normal(size=7).astype(np.float32)
    stats = rs.normal(size=(3, 7)).astype(np.float32)
    _close(sequential_ema(_t(run), _t(stats), 0.1),
           jnorm.sequential_ema(jnp.asarray(run), jnp.asarray(stats), 0.1))


@pytest.mark.parametrize("groups", [1, 3])
def test_batchnorm_train_matches_jax(groups):
    """Output, input/scale/bias gradients and the running statistics after
    two train-mode calls, on group-major inputs."""
    rs = np.random.default_rng(groups)
    B, H, W, C = 2, 5, 6, 8
    xs = [(1.0 + 2.0 * rs.normal(size=(groups, B, H, W, C))).astype(
        np.float32) for _ in range(2)]
    cot = rs.normal(size=(groups, B, H, W, C)).astype(np.float32)
    scale = (1.0 + 0.1 * rs.normal(size=C)).astype(np.float32)
    bias = (0.1 * rs.normal(size=C)).astype(np.float32)
    jbn = JaxBatchNorm(C)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    bn = BatchNormTorch(C).train()
    bn.weight.data.copy_(_t(scale))
    bn.bias.data.copy_(_t(bias))
    nchw = lambda a: _t(np.moveaxis(a, -1, 2).reshape(groups * B, C, H, W))
    for xk in xs:
        def jf(p, x):
            return jbn.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             x, use_running_average=False,
                             mutable=["batch_stats"])
        jy, muts = jf(variables["params"], jnp.asarray(xk))
        _, vjp = jax.vjp(lambda p, x: jf(p, x)[0], variables["params"],
                         jnp.asarray(xk))
        jgp, jgx = vjp(jnp.asarray(cot))
        variables["batch_stats"] = muts["batch_stats"]
        x = nchw(xk).requires_grad_(True)
        y = bn(x, groups)
        gx, gw, gb = torch.autograd.grad(y, (x, bn.weight, bn.bias),
                                         nchw(cot))
        want_y = np.moveaxis(np.asarray(jy), -1, 2).reshape(y.shape)
        _close(y, want_y, atol=1e-5)
        _close(gx, np.moveaxis(np.asarray(jgx), -1, 2).reshape(x.shape),
               atol=1e-5)
        _close(gw, jgp["scale"], rtol=1e-4, atol=1e-4)
        _close(gb, jgp["bias"], rtol=1e-4, atol=1e-4)
        _close(bn.running_mean, variables["batch_stats"]["mean"])
        _close(bn.running_var, variables["batch_stats"]["var"])


def test_batchnorm_eval_ignores_groups_and_keeps_stats():
    bn = BatchNormTorch(4).eval()
    x = torch.randn(6, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    before = bn.running_mean.clone()
    torch.testing.assert_close(bn(x, 3), bn(x))
    assert torch.equal(bn.running_mean, before)


@pytest.mark.parametrize("fn", ["max_pool", "avg_pool"])
def test_pooling_matches_jax(fn):
    rs = np.random.default_rng(1)
    x = rs.normal(size=(2, 3, 32, 48, 4)).astype(np.float32)      # NHWC
    want = getattr(jpool, fn)(jnp.asarray(x), 16)
    got = {"max_pool": max_pool, "avg_pool": avg_pool}[fn](
        _t(np.moveaxis(x, -1, -3)), 16)
    _close(got, np.moveaxis(np.asarray(want), -1, -3))


# ---- the shipped losses ----------------------------------------------------

M, B, H, W, C = 3, 4, 32, 32, 2
MASKS = {
    "all_present": np.ones((B, M), np.float32),
    "one_missing": np.array([[1, 0, 1], [1, 1, 1], [0, 1, 1], [1, 1, 0]],
                            np.float32),
    "modality_absent": np.array([[1, 0, 1], [1, 0, 1], [0, 0, 1],
                                 [1, 0, 1]], np.float32),
    "all_missing": np.zeros((B, M), np.float32),
}


@pytest.fixture(scope="module")
def loss_inputs():
    rs = np.random.default_rng(3)
    return {"x": rs.normal(size=(M, B, H, W, C)).astype(np.float32),
            "grid": rs.normal(size=(M, M, B, H, W, C)).astype(np.float32),
            "s": rs.dirichlet(np.ones(C), size=(M, B, H, W)).astype(
                np.float32),
            "z": rs.normal(size=(M, B, 16)).astype(np.float32),
            "z_new": rs.normal(size=(M, B, 16)).astype(np.float32)}


def _loss_pairs(d, mask, p):
    """(name, port value, JAX value) for every shipped loss."""
    jm, tm = jnp.asarray(mask), _t(mask)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: _t(v) for k, v in d.items()}
    diag_j = j["grid"][jnp.arange(M), jnp.arange(M)]
    diag_t = t["grid"].diagonal(0, 0, 1).movedim(-1, 0)
    return [
        ("recon_x", losses.recon_loss_x(t["x"], diag_t, tm, p),
         JL.recon_loss_x(j["x"], diag_j, jm, p)),
        ("recon_x_mix", losses.recon_loss_x_mix(t["x"], t["grid"], tm, p),
         JL.recon_loss_x_mix(j["x"], j["grid"], jm, p)),
        ("latent_z", losses.latent_z_loss(t["z"], t["z_new"], tm),
         JL.latent_z_loss(j["z"], j["z_new"], jm)),
        ("sim_s", losses.similarity_s_loss(t["s"], tm, (2, 0)),
         JL.similarity_s_loss(j["s"], jm, jnp.asarray([2, 0]))),
        ("sim_z", losses.similarity_z_loss(t["z"], tm),
         JL.similarity_z_loss(j["z"], jm)),
    ]


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_shipped_losses_match_jax(loss_inputs, mask_name, p):
    mask = MASKS[mask_name]
    for name, got, want in _loss_pairs(loss_inputs, mask, p):
        _close(got, want, err_msg=name)
        if mask_name == "all_missing":
            assert float(got) == 0.0, name


def test_all_missing_losses_have_zero_finite_grads(loss_inputs):
    """The branch-free normalization keeps the gradient finite (and zero)
    where every mask is empty."""
    d = {k: _t(v).requires_grad_(True) for k, v in loss_inputs.items()}
    tm = _t(MASKS["all_missing"])
    diag = d["grid"].diagonal(0, 0, 1).movedim(-1, 0)
    total = (losses.recon_loss_x(d["x"], diag, tm)
             + losses.recon_loss_x_mix(d["x"], d["grid"], tm)
             + losses.latent_z_loss(d["z"], d["z_new"], tm)
             + losses.similarity_s_loss(d["s"], tm, (0, 1))
             + losses.similarity_z_loss(d["z"], tm))
    total.backward()
    for k, v in d.items():
        assert torch.isfinite(v.grad).all() and float(v.grad.abs().max()) \
            == 0.0, k


def test_empty_mix_pair_contributes_nothing(loss_inputs):
    """Modality 1 absent for the whole batch: every pair with it is empty;
    the mix loss averages the remaining pairs only, as in JAX."""
    mask = MASKS["modality_absent"]
    d = loss_inputs
    got = losses.recon_loss_x_mix(_t(d["x"]), _t(d["grid"]), _t(mask), 1)
    want = JL.recon_loss_x_mix(jnp.asarray(d["x"]), jnp.asarray(d["grid"]),
                               jnp.asarray(mask), 1)
    _close(got, want)
    keep = np.zeros((M, M), bool)
    keep[0, 2] = keep[2, 0] = True
    r = np.abs(d["x"][None] - d["grid"]).mean(axis=(3, 4, 5))   # [i, j, B]
    mm = mask.T[:, None, :] * mask.T[None, :, :]
    per = (mm * r).sum(-1) / np.where(mm.sum(-1) > 0, mm.sum(-1), 1)
    _close(got, per[keep].mean())


@pytest.mark.parametrize("method", ["max", "mean"])
def test_compact_s_and_cosine_match_jax(loss_inputs, method):
    s = loss_inputs["s"][0]
    got = losses.compact_s(_t(s), method)
    want = JL.compact_s(jnp.asarray(s), method)
    _close(got, want)
    a, b = loss_inputs["z"][0], loss_inputs["z"][1]
    _close(losses.cosine(_t(a), _t(b)), JL.cosine(jnp.asarray(a),
                                                   jnp.asarray(b)))
    _close(losses.cosine(torch.zeros(3, 5), torch.zeros(3, 5)),
           JL.cosine(jnp.zeros((3, 5)), jnp.zeros((3, 5))))


# ---- optimizer, clipping, schedule, pairs, config --------------------------

def test_clip_global_norm_matches_jax():
    rs = np.random.default_rng(4)
    tree = {"a": rs.normal(size=(3, 4)).astype(np.float32),
            "b": rs.normal(size=(5,)).astype(np.float32)}
    for max_norm in (1.0, 100.0):
        jc, jn = joptim.clip_global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
        ts = [_t(tree["a"]), _t(tree["b"])]
        n = optim.clip_global_norm(ts, max_norm)
        _close(n, jn)
        _close(ts[0], jc["a"])
        _close(ts[1], jc["b"])


def test_adam_matches_adam_amsgrad_torch():
    """Three Adam(amsgrad, L2 weight decay) steps with changing grads."""
    rs = np.random.default_rng(5)
    p0 = {"w": rs.normal(size=(4, 3)).astype(np.float32),
          "b": rs.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rs.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    cfg = config.Config(lr=1e-2, weight_decay=1e-2)
    tx = joptim.adam_amsgrad_torch(weight_decay=cfg.weight_decay)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    params = [torch.nn.Parameter(_t(p0["w"])), torch.nn.Parameter(_t(p0["b"]))]
    opt = optim.make_optimizer(params, cfg)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp, learning_rate=cfg.lr)
        jp = jax.tree.map(jnp.add, jp, upd)
        params[0].grad, params[1].grad = _t(g["w"]), _t(g["b"])
        opt.step()
    _close(params[0], jp["w"], rtol=1e-5, atol=1e-7)
    _close(params[1], jp["b"], rtol=1e-5, atol=1e-7)


def test_reduce_lr_on_plateau_matches_jax():
    metrics = [1.0, 0.9, 0.9, 0.95, 0.91, 0.9, 0.92, 0.93, 0.5, 0.6, 0.6,
               0.7, 0.8, 0.9, 0.99, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    ours = optim.ReduceLROnPlateau(2e-4, patience=2)
    ref = joptim.ReduceLROnPlateau(2e-4, patience=2)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.Adam([p], lr=2e-4)
    for m in metrics:
        assert ours.step(m) == ref.step(m)
        ours.apply(opt)
        assert opt.param_groups[0]["lr"] == ref.lr
    assert ours.lr < 2e-4 and ours.state_dict() == ref.state_dict()


@pytest.mark.parametrize("modality_num", [2, 4])
def test_draw_pairs_and_keys_match_jax(modality_num):
    got = train.draw_pairs(np.random.default_rng(9), modality_num, 5)
    want = jtrain.draw_pairs(np.random.default_rng(9), modality_num, 5)
    np.testing.assert_array_equal(got, want)
    assert train.LOSS_KEYS == jtrain.LOSS_KEYS
    assert train.METRIC_KEYS == jtrain.METRIC_KEYS
    vec = np.arange(len(train.METRIC_KEYS), dtype=np.float32)
    assert train.metrics_to_dict(torch.from_numpy(vec)) == \
        jtrain.metrics_to_dict(vec)


TRAIN_FIELDS = ("lr", "p", "lambda_recon_y", "lambda_recon_y_fused",
                "lambda_recon_x", "lambda_recon_x_mix", "lambda_sim_s",
                "lambda_sim_z", "lambda_kl", "lambda_latent_z",
                "lambda_adv_s", "s_compact_method", "s_sim_method",
                "z_sim_method", "effective_batch", "grad_clip_norm",
                "weight_decay", "continue_train", "fix_pretrain", "fuse_bn")


def test_config_training_fields_match_jax():
    ours, ref = config.Config().derive(), JaxConfig().derive()
    for name in TRAIN_FIELDS:
        assert getattr(ours, name) == getattr(ref, name), name
    flag = config.flagship()
    assert (flag.lr, flag.p, flag.effective_batch) == (2e-4, 1, 16)
    assert (flag.lambda_recon_x, flag.lambda_recon_x_mix, flag.lambda_sim_s,
            flag.lambda_sim_z, flag.lambda_latent_z) == (1.0, 2.0, 10.0, 2.0,
                                                         0.1)
    adv = dataclasses.replace(config.Config(), lambda_adv_s=1.0).derive()
    assert adv.is_discrim_s
    with pytest.raises(ValueError, match="multiple of batch_size"):
        config.Config(batch_size=6, effective_batch=16).validate()
    with pytest.raises(ValueError, match="s_sim_method"):
        config.Config(s_sim_method="dot").validate()
