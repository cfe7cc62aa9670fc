"""The port's data-parallel 2D step (``mesh_shape: {data: N}``,
parallel/mesh.py) on the CPU: N gloo processes (``parallel.mesh.spawn``,
one intra-op thread each), tiny widths.

- the DP train step at N = 2 and 4, with and without ``fuse_bn`` (K6/K7's
  plain versions on the CPU), two microbatches per step (ZeroDose's
  accumulation), two steps, z sampled from the generator: against the
  unsharded port step on the same global batch, loss terms rtol 1e-5,
  gradient norm rtol 1e-4, parameters and BatchNorm running statistics
  atol 5e-4 (tests/test_sharding.py's limits: the first Adam steps move
  each weight by about lr * sign(g), so reduction-order noise on a
  near-zero gradient can flip one by up to 2 lr = 4e-4).  Measured: loss
  within 2.7e-6, gradient norm within 1.4e-5, state within 2.2e-4;
- the same step (N = 2, ``fuse_bn``, z = the encoder mean, plain
  convolutions) against the JAX package's step on a 2-device data mesh of
  the virtual CPU mesh (tests/conftest.py) from the same weights, at the
  same limits;
- ``evaluate`` on the mesh against the unsharded loop (rtol 2e-4, atol
  1e-6, tests/test_sharding.py's), with the batches cut by ``evaluate``
  and given as the ranks' rows;
- the mesh checks of ``mesh_from_config`` and the batch and plan cuts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.parallel import mesh
from representation_disentanglement_torch.training import (
    epoch, evaluate as ev, optim, train)
from tests import torch_parallel_workers as workers
from tests.test_torch_train_configs import few_threads  # noqa: F401

M, B, H, W, CB, A = 2, 4, 32, 64, 7, 2
OTHERS = {"mod_enc_s": False, "ana_dec_act": "softmax", "old": False,
          "softmax_remove_mask": True}
BASE = dict(contrast_list=["T1", "T2"], input_height=H, input_width=W,
            batch_size=B, effective_batch=A * B, use_pallas=True,
            notshared_impl="loop", others=OTHERS)
PAIRS = np.array([[1, 0], [0, 1]], np.int32)
STEPS = 2


def weights(kw, seed=1):
    """The port's initial weights, the zero-initialized biases made
    nonzero (tests/test_torch_train_configs.py's reason)."""
    cfg = Config(**kw).derive().validate()
    port = build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    rs = np.random.default_rng(7)
    sd = {}
    for k, v in port.state_dict().items():
        if k.endswith(".bias") and not v.any():
            v = torch.from_numpy(rs.normal(0.0, 0.05, v.shape).astype(
                np.float32))
        sd[k] = v.clone()
    return sd


def eval_batches():
    """Two eval batches, one row of each not valid (a padded row)."""
    out = []
    for seed in (3, 4):
        b = workers.np_batch(np.random.default_rng(seed), 1, M, B, H, W, CB)
        out.append(dict({k: v[0] for k, v in b.items()},
                        valid=np.array([1, 1, 0, 1], bool)))
    return out


def unsharded(kw, sd, batch, seed=0):
    cfg, model = workers.port_2d(kw, sd)
    dopt = optim.make_d_optimizer(model.parameters(), cfg) \
        if cfg.is_discrim_s else None
    step = train.make_train_step(model, cfg, optim.make_optimizer(
        model.parameters(), cfg), dopt)
    gen = torch.Generator().manual_seed(seed)
    ms = [train.metrics_to_dict(step(batch, gen, PAIRS, PAIRS,
                                     first_of_epoch=(i == 0)))
          for i in range(STEPS)]
    return ms, model.state_dict()


KW = {fuse: dict(BASE, fuse_bn=fuse) for fuse in (False, True)}
JAX_KW = dict(BASE, fuse_bn=True, is_cond=False)


@pytest.fixture(scope="module")
def inputs():
    batch = workers.np_batch(np.random.default_rng(11), A, M, B, H, W, CB)
    return batch, {f: weights(KW[f]) for f in KW}, weights(JAX_KW)


@pytest.fixture(scope="module")
def runs(inputs):
    """Per N, the DP results of every case, from one set of processes."""
    batch, sds, jsd = inputs
    cache = {}

    def get(n):
        if n not in cache:
            jobs = [("dp_steps", (KW[f], sds[f], batch, PAIRS, STEPS,
                                  False, 0)) for f in (False, True)]
            if n == 2:
                jobs.append(("dp_steps", (JAX_KW, jsd, batch, PAIRS, 1,
                                          True, 0)))
                jobs += [("dp_eval", (KW[False], sds[False],
                                      eval_batches(), local))
                         for local in (False, True)]
            cache[n] = mesh.spawn(n, workers.run_jobs, jobs, device="cpu")
        return cache[n]

    return get


def assert_state(got, want, atol=5e-4):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), atol=atol,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fuse_bn"])
@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_unsharded(runs, inputs, n, fuse):
    batch, sds, _ = inputs
    got_m, got_sd = runs(n)[int(fuse)]
    want_m, want_sd = unsharded(KW[fuse], sds[fuse], batch)
    # step 0 is computed from the same weights: every term at 1e-5; step
    # 1 from weights 2 lr apart where an Adam step flipped a sign
    for i, (g, w) in enumerate(zip(got_m, want_m)):
        for k in train.LOSS_KEYS if i == 0 else ("all",):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5 if i == 0
                                       else 5e-5, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4, err_msg=f"step {i}")
    assert got_m[1]["all"] != got_m[0]["all"]
    assert_state(got_sd, want_sd)


def test_dp_step_matches_jax_sharded_step(runs, inputs, monkeypatch):
    from representation_disentanglement_tpu.config import Config as JaxConfig
    from representation_disentanglement_tpu.main_missing import (
        build_model as jax_build_model)
    from representation_disentanglement_tpu.models.multimodal import (
        MultimodalModel as JaxModel)
    from representation_disentanglement_tpu.parallel import (
        make_mesh, replicate, shard_batch)
    from representation_disentanglement_tpu.training import optim as joptim
    from representation_disentanglement_tpu.training import train as jtrain
    from representation_disentanglement_tpu.utils.transplant import (
        transplant_multimodal)
    from representation_disentanglement_torch.weights import from_jax_params

    batch, _, jsd = inputs
    monkeypatch.setattr(JaxModel, "sample_z", lambda self, rng, m, lv: m)
    params, stats = transplant_multimodal(
        {k: v.numpy() for k, v in jsd.items()}, M, (H, W), is_cond=False,
        notshared_impl="loop")
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)
    jcfg = JaxConfig(**dict(JAX_KW, fuse_bn=False, remat=False)) \
        .derive().validate()
    tx = joptim.adam_amsgrad_torch(weight_decay=jcfg.weight_decay)
    state = jtrain.TrainState(params, stats, tx.init(params), (), ())
    jstep, n_micro = jtrain.make_train_step(jax_build_model(jcfg), jcfg,
                                            (tx, tx), donate=False)
    assert n_micro == A
    dmesh = make_mesh(2)
    state = type(state)(*[replicate(s, dmesh) for s in state])
    jb = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, dmesh,
                     stacked=True)
    state, m = jstep(state, jb, jax.random.split(jax.random.PRNGKey(0), A),
                     jnp.asarray(PAIRS), jnp.asarray(PAIRS),
                     jnp.float32(jcfg.lr), first_of_epoch=True)
    want = jtrain.metrics_to_dict(m)
    (got,), got_sd = runs(2)[2]
    np.testing.assert_allclose(got["all"], want["all"], rtol=1e-5)
    want_sd = from_jax_params(jax.tree.map(np.asarray, state.params),
                              jax.tree.map(np.asarray, state.batch_stats),
                              modality_num=M, input_size=(H, W))
    assert_state({k: got_sd[k] for k in want_sd},
                 {k: torch.as_tensor(np.asarray(v)) for k, v in
                  want_sd.items()})


@pytest.mark.parametrize("rank_local", [False, True],
                         ids=["cut_by_evaluate", "rank_rows"])
def test_dp_eval_matches_unsharded(runs, inputs, rank_local):
    _, sds, _ = inputs
    got = runs(2)[3 + int(rank_local)]
    cfg, model = workers.port_2d(KW[False], sds[False])
    want = ev.evaluate(model, cfg, eval_batches())
    assert set(got) == set(want) and "ssim" in want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)


def test_mesh_from_config_checks():
    cfg = Config(**dict(BASE, mesh_shape={"data": 1})).derive()
    assert mesh.mesh_from_config(cfg, "cpu") is None
    cfg.mesh_shape = {"data": 3}
    with pytest.raises(ValueError, match="divisible by the data-mesh"):
        mesh.mesh_from_config(cfg, "cpu")
    cfg.mesh_shape = {"data": 2}
    with pytest.raises(ValueError, match="needs 2 cards"):
        mesh.mesh_from_config(cfg, "cuda")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.mesh_from_config(cfg, "cpu")


def test_shard_batch_and_plan_take_the_rank_block():
    axis = mesh.Axis(None, 1, 2, (0, 1))
    batch = workers.np_batch(np.random.default_rng(0), A, M, B, H, W, CB)
    batch["subj_id"] = list("abcd")
    local = mesh.shard_batch(batch, axis, stacked=True)
    np.testing.assert_array_equal(local["inputs"],
                                  batch["inputs"][:, :, 2:])
    np.testing.assert_array_equal(local["mask"], batch["mask"][:, 2:])
    assert local["subj_id"] == ["c", "d"]
    rows = torch.arange(3 * A * B).reshape(3, A, B)
    plan = epoch.EpochPlan(rows, rows + 100, rows[..., None].float(),
                           np.zeros((3, A, 2)), np.ones((3, A, 2)))
    cut = mesh.shard_epoch_plan(plan, axis)
    assert torch.equal(cut.rows, rows[:, :, 2:])
    assert torch.equal(cut.slices, rows[:, :, 2:] + 100)
    assert cut.sim is plan.sim
