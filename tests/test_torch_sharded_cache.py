"""The device volume cache sharded over a data mesh (``data/
device_store.py``'s ``ShardedVolumeCache`` and its loaders, training/
epoch.py's sharded plan, ``main_missing.run`` under ``mesh_shape: {data:
N}``) on the CPU.

- each rank holds ceil(S/N) subjects, dealt round-robin, its padding rows
  absent;
- the sharded epoch plan of every rank (rows, slices, dropoff, the pairs)
  equals the JAX package's ``_epoch_indices_sharded`` plan on the same
  seed, column for column; the eval loader's plan equals JAX's and visits
  every sample once;
- one epoch over the sharded cache on 2 gloo processes equals the
  unsharded port epoch fed the same batch composition from a replicated
  cache (tests/test_sharded_cache.py's check of the JAX package): the
  first step's metrics to rtol 1e-5, the epoch's at that test's rtol 2e-3
  / atol 1e-4, and the weights to atol 5e-4 (2 lr);
- ``main_missing.run`` on 2 processes: over the sharded cache (only rank
  0 writes: one row per epoch in ``stat.csv``) and resumed on one card
  from its checkpoint; over the host loader, whose DP epoch equals the
  unsharded one (rtol 1e-5).

Model and data as tests/test_torch_parallel_dp.py: M = 2, 32x64, B = 4,
two microbatches; 5 phantom subjects (3 for the epoch check) at 32x64x24.
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_torch import config, main_missing
from representation_disentanglement_torch.data import synthetic
from representation_disentanglement_torch.data.dataset import (
    VolumeStore, fold_txt_names, load_idx_list)
from representation_disentanglement_torch.data.device_store import (
    ShardedDeviceBatchLoader, ShardedEvalBatchLoader, build_device_cache,
    build_sharded_device_cache)
from representation_disentanglement_torch.data.preprocess import (
    write_fold_txts)
from representation_disentanglement_torch.parallel import mesh
from representation_disentanglement_torch.training import epoch, optim
from tests import torch_parallel_workers as workers
from tests.test_torch_parallel_dp import BASE, weights
from tests.test_torch_train_configs import few_threads  # noqa: F401

CONTRASTS = ("T1", "T2")
SHAPE = (32, 64, 24)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """5 subjects with T2 missing in one; train 4 of them at slices 6-11,
    val 1, test 1 (the one shared with train: its slices 6-7)."""
    vols, subjects, _ = synthetic.synthetic_volumes(
        "BraTS", CONTRASTS, "z-score", 5, SHAPE, seed=4)
    del vols[f"{subjects[2]}/T2"]
    path = str(tmp_path_factory.mktemp("data"))
    write_fold_txts(
        synthetic.one_fold((subjects[:4], subjects[4:], subjects[:1]),
                           slice_range=(6, 12)),
        path, synthetic.by_split(fold_txt_names("BraTS", 0, 2)))
    subj, idx = load_idx_list(os.path.join(path,
                                           "fold_BraTS_0_train_noval.txt"))
    return path, vols, subj, idx


def fake_axis(rank, n):
    return mesh.Axis(None, rank, n, tuple(range(n)))


def sharded(data, n, rank, dtype=torch.float32):
    _, vols, subj, _ = data
    return build_sharded_device_cache("BraTS", VolumeStore(data=vols), subj,
                                      list(CONTRASTS), fake_axis(rank, n),
                                      dtype=dtype, device="cpu")


@pytest.mark.parametrize("n", [2, 3])
def test_each_rank_holds_ceil_s_over_n_subjects(data, n):
    _, vols, subj, _ = data
    full = build_device_cache("BraTS", VolumeStore(data=vols), subj,
                              list(CONTRASTS), dtype=torch.float32,
                              device="cpu")
    s_loc = -(-len(full.subjects) // n)
    for r in range(n):
        c = sharded(data, n, r)
        assert c.vols.shape == (s_loc,) + full.vols.shape[1:]
        assert c.nbytes_per_card == full.nbytes // len(full.subjects) * s_loc
        for loc in range(s_loc):
            name = c.subjects[r * s_loc + loc]
            assert c.row.get(name, r * s_loc + loc) == r * s_loc + loc
            if not name:                              # padding
                assert not c.presence[loc].any()
                continue
            g = full.row[name]
            assert g % n == r and g // n == loc       # round-robin
            assert torch.equal(c.vols[loc], full.vols[g])
            assert torch.equal(c.presence[loc], full.presence[g])


def jax_sharded(data, n):
    from representation_disentanglement_tpu.data.dataset import (
        VolumeStore as JaxStore)
    from representation_disentanglement_tpu.data import device_store as jds
    from representation_disentanglement_tpu.parallel import make_mesh
    _, vols, subj, _ = data
    return jds, jds.build_sharded_device_cache(
        "BraTS", JaxStore(data=vols), subj, list(CONTRASTS), make_mesh(n),
        dtype=jnp.float32)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_plans_equal_the_jax_plans(data, n):
    import jax
    from representation_disentanglement_tpu.training.epoch import (
        epoch_indices as jax_epoch_indices)
    _, _, subj, idx = data
    jds, jcache = jax_sharded(data, n)
    jl = jds.ShardedDeviceBatchLoader(jcache, subj, idx, 4, shuffle=True,
                                      dropoff=True, seed=10)
    (rows, slices, drop, _, sim, adv), _ = jax_epoch_indices(
        jl, 1, 2, np.random.default_rng(10), jax.random.PRNGKey(0))
    jev = jds.ShardedEvalBatchLoader(jcache, subj, idx, 4, dropoff=True,
                                     seed=10)
    jevals = list(jev)
    for r in range(n):
        c = sharded(data, n, r)
        loader = ShardedDeviceBatchLoader(c, subj, idx, 4, shuffle=True,
                                          dropoff=True, seed=10)
        plan = epoch.epoch_indices(loader, 1, 2, np.random.default_rng(10))
        np.testing.assert_array_equal(plan.rows.numpy(),
                                      np.asarray(rows)[:, :, r])
        np.testing.assert_array_equal(plan.slices.numpy(),
                                      np.asarray(slices)[:, :, r])
        np.testing.assert_array_equal(plan.drop.numpy(),
                                      np.asarray(drop)[:, :, r])
        np.testing.assert_array_equal(plan.sim, np.asarray(sim))
        np.testing.assert_array_equal(plan.adv, np.asarray(adv))
        ev = list(ShardedEvalBatchLoader(c, subj, idx, 4, dropoff=True,
                                         seed=10))
        assert len(ev) == len(jevals)
        b = 4 // n
        for got, want in zip(ev, jevals):
            cut = slice(r * b, (r + 1) * b)
            assert got["subj_id"] == want["subj_id"][cut]
            np.testing.assert_array_equal(got["valid"], want["valid"][cut])
            for k in ("inputs", "mask", "targets", "mask_img"):
                np.testing.assert_allclose(
                    got[k].numpy(), np.asarray(want[k])[
                        (slice(None),) * (1 if k == "inputs" else 0) + (cut,)],
                    err_msg=k)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_eval_loader_visits_every_sample_once(data, n):
    _, _, subj, idx = data
    seen = []
    for r in range(n):
        for batch in ShardedEvalBatchLoader(sharded(data, n, r), subj, idx,
                                            6):
            v = batch["valid"]
            assert not batch["mask"][~torch.as_tensor(v)].any()
            seen += [(s, int(i)) for s, i, ok in zip(
                batch["subj_id"], batch["slice_idx"], v) if ok]
    assert sorted(seen) == sorted(zip(map(str, subj), map(int, idx)))


def test_sharded_epoch_matches_the_replicated_epoch(data):
    _, vols, subj, idx = data
    kw = dict(BASE, contrast_list=list(CONTRASTS))
    sd = weights(kw)
    metrics, got_sd, names, slices, drop, sim, adv = mesh.spawn(
        2, workers.sharded_epoch, kw, sd, vols, subj, idx, device="cpu")
    assert metrics.shape[0] >= 1
    cfg, model = workers.port_2d(kw, sd)
    full = build_device_cache("BraTS", VolumeStore(data=vols), subj,
                              list(CONTRASTS), dtype=torch.float32,
                              device="cpu")
    rows = np.vectorize(full.row.get)(names)
    run_epoch, _ = epoch.make_train_epoch(
        model, cfg, optim.make_optimizer(model.parameters(), cfg), full,
        None)
    plan = epoch.EpochPlan(torch.as_tensor(rows), torch.as_tensor(slices),
                           torch.as_tensor(drop), sim, adv)
    want = run_epoch(plan, True)
    # each step's metrics at rtol 1e-5 before the first update; the
    # later ones at tests/test_sharded_cache.py's limits (its weights then
    # 2 lr apart where an Adam step flipped a sign)
    np.testing.assert_allclose(metrics[0].numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(metrics.numpy(), want.numpy(), rtol=2e-3,
                               atol=1e-4)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=5e-4,
                                   err_msg=k)


def run_cfg(data, n, label, **kw):
    d = dict(BASE, contrast_list=list(CONTRASTS), epochs=1,
             data_path=data[0] + "/", compute_dtype="float32",
             mesh_shape={"data": n}, log_every=0, ckpt_timelabel=label,
             epoch_chunk_steps=1)
    d.update(kw)
    return config.Config(**d).derive().validate()


def stat_rows(path):
    with open(os.path.join(path, "stat.csv")) as f:
        return [row[1] for row in csv.reader(f)][1:]


def test_dp_run_writes_once_and_resumes_on_one_card(data, tmp_path):
    store = VolumeStore(data=data[1])
    root = str(tmp_path)
    out = main_missing.run(run_cfg(data, 2, "dp"), root, device="cpu",
                           store=store)
    assert out["mesh"] == 2 and out["loader"] == "device"
    assert out["cache_bytes_per_card"] < out["cache_bytes"]
    assert stat_rows(out["ckpt_path"]) == ["epoch[ 0]", "val"]
    assert sorted(f for f in os.listdir(out["ckpt_path"])
                  if f.endswith(".ckpt")) == ["epoch000.ckpt",
                                              "model_best.ckpt"]
    assert np.isfinite(out["epochs"][0]["train"]["all"])
    res = main_missing.run(
        run_cfg(data, 1, os.path.basename(out["ckpt_path"]), epochs=2,
                continue_train=True, load_yaml=False,
                ckpt_name="epoch000.ckpt"), root, device="cpu",
        store=store)
    assert res["start_epoch"] == 0 and res["optimizer_loaded"]
    assert res["restored"][0] == res["restored"][1]
    assert stat_rows(out["ckpt_path"]) == ["epoch[ 0]", "val",
                                           "epoch[ 1]", "val"]


def test_dp_run_over_the_host_loader_equals_one_card(data, tmp_path):
    store = VolumeStore(data=data[1])
    got = main_missing.run(run_cfg(data, 2, "h2", device_data_cache=False),
                           str(tmp_path), device="cpu", store=store)
    want = main_missing.run(run_cfg(data, 1, "h1", device_data_cache=False),
                            str(tmp_path), device="cpu", store=store)
    assert got["loader"] == want["loader"] == "host"
    g, w = got["epochs"][0], want["epochs"][0]
    assert g["steps"] == w["steps"]
    for k in g["train"]:
        np.testing.assert_allclose(g["train"][k], w["train"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in w["val"]:
        np.testing.assert_allclose(g["val"][k], w["val"][k], rtol=2e-4,
                                   atol=1e-6, err_msg=k)
