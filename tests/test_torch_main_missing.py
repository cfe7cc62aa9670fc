"""A whole training run of the port (``main_missing``) against the JAX
package's, on the CPU, from the same weights and data.

Model and data: the flagship structure at a small size (M=2: T1 and T2,
32x64, B=2, ``effective_batch`` 4, so two microbatches per optimizer
step, f32, the shipped five losses), the JAX package's synthetic HDF5
data (32x64x16) with fold txts of 8 train slices (two optimizer steps per
epoch), 4 val slices (two val batches) and 2 test slices, through the
device volume cache (bf16, as the flagship's).  Both sides start from the
JAX initialization with its zero-initialized biases made small and
nonzero (the LeakyReLU tie at 0, tests/test_torch_train_model.py), take z
= the encoder mean (``sample_z`` patched) and run two epochs.

Tolerances, with what was measured on a CPU:
- every ``stat.csv`` value (train and val rows, both epochs): rtol 2e-3,
  atol 1e-6, tests/test_torch_train_step.py's (measured at most 1.4e-4
  relative);
- final parameters, as the update each side made from the common start:
  per tensor the L2 gap at most 5e-2 of the JAX update (measured at most
  1.2e-2, on the bias of a convolution that a BatchNorm follows, whose
  gradient is zero up to rounding, so that Adam moves it by noise; median
  4.8e-5), all tensors together 2e-3 (measured 1.9e-4);
- BatchNorm running statistics, per tensor: the max abs gap at most 5e-3
  of the tensor's max abs value (measured 7.5e-4);
- the scheduler's lr and bad-epoch count, which checkpoints exist and the
  epoch each holds (so the best epoch): equal; its best value rtol 2e-3.

The port-only cases (preemption and resume, the CLI, the test phase
without a checkpoint; the fused BatchNorm in
tests/test_torch_main_missing_fused.py) start from the same weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu import main_missing as jmain
from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.data.synthetic import (
    make_synthetic_dataset)
from representation_disentanglement_tpu.models.multimodal import (
    MultimodalModel as JaxModel)
from representation_disentanglement_tpu.training import (
    checkpoint as jckpt, optim as joptim, train as jtrain)
from representation_disentanglement_tpu.utils.preempt import (
    PreemptionGuard as JaxGuard)
from representation_disentanglement_torch import config, main_missing
from representation_disentanglement_torch.data.dataset import VolumeStore
from representation_disentanglement_torch.models.multimodal import (
    MultimodalModel, build_model)
from representation_disentanglement_torch.training import (
    checkpoint, optim)
from representation_disentanglement_torch.utils.preempt import (
    PREEMPT_NAME, PreemptionGuard, latest_resume_checkpoint)
from representation_disentanglement_torch.weights import from_jax_params

h5py = pytest.importorskip("h5py")

M, B, H, W, D = 2, 2, 32, 64, 16
CFG = dict(contrast_list=["T1", "T2"], input_height=H, input_width=W,
           batch_size=B, effective_batch=2 * B, use_pallas=True,
           notshared_impl="loop", epochs=2, log_every=1,
           others={"mod_enc_s": False, "ana_dec_act": "softmax",
                   "old": False, "softmax_remove_mask": True})
STAT_RTOL, STAT_ATOL = 2e-3, 1e-6
UPDATE_REL, UPDATES_REL, BN_STAT_REL = 5e-2, 2e-3, 5e-3


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(d, "BraTS", ("T1", "T2"), "z-score", n_subj=3,
                           shape=(H, W, D), seed=2)
    subjects = [f"BraTS20_Training_{i:03d}" for i in range(3)]
    for split, subj, slices in (("train", subjects[0], range(4, 12)),
                                ("val", subjects[1], range(5, 9)),
                                ("test", subjects[2], range(6, 8))):
        with open(os.path.join(d, f"fold_BraTS_0_{split}_noval.txt"),
                  "w") as f:
            f.writelines(f"{subj} {s}\n" for s in slices)
    return d


@pytest.fixture(scope="module")
def start(data_dir):
    """The JAX train state (zero biases made nonzero) and the port's
    state_dict with the same weights."""
    jcfg = JaxConfig(**CFG, remat=False, data_path=data_dir
                     ).derive().validate()
    jmodel = jmain.build_model(jcfg)
    rs = np.random.default_rng(3)
    sample = {"inputs": jnp.asarray(rs.normal(size=(M, B, H, W, 7)),
                                    jnp.float32),
              "mask": jnp.ones((B, M)), "mask_img": jnp.zeros((B, H, W))}
    state, txs = jtrain.create_train_state(jmodel, jcfg,
                                           jax.random.PRNGKey(1), sample)
    rs = np.random.default_rng(7)

    def fix(path, a):
        if path[-1].key == "bias" and not np.any(np.asarray(a)):
            return jnp.asarray(rs.normal(0.0, 0.05, a.shape), jnp.float32)
        return a

    state = state._replace(
        params=jax.tree_util.tree_map_with_path(fix, state.params))
    sd = from_jax_params(jax.tree.map(np.asarray, state.params),
                         jax.tree.map(np.asarray, state.batch_stats),
                         modality_num=M, input_size=(H, W))
    return jmodel, state, txs, sd


@pytest.fixture
def z_is_the_mean(monkeypatch):
    monkeypatch.setattr(JaxModel, "sample_z", lambda self, rng, m, lv: m)
    monkeypatch.setattr(MultimodalModel, "sample_z",
                        lambda self, gen, m, lv: m)


def _read_stat(path):
    with open(path) as f:
        head, *rows = [line.rstrip("\n").split(",") for line in f]
    return head, [(r[1], np.array([float(x) if x else np.nan
                                   for x in r[2:]])) for r in rows]


def _jax_run(start, data_dir, ckpt, **kw):
    jmodel, state, txs, _ = start
    jcfg = JaxConfig(**dict(CFG, remat=False, data_path=data_dir, **kw)
                     ).derive().validate()
    jcfg.ckpt_path = ckpt
    os.makedirs(ckpt)
    loaders = jmain.make_loaders(jcfg)
    sched = joptim.ReduceLROnPlateau(jcfg.lr)
    state = jmain.train(jcfg, jmodel, state, txs, loaders, -1, sched,
                        guard=JaxGuard())
    return state, sched, loaders


def _port_cfg(data_dir, **kw):
    return config.Config(**dict(CFG, data_path=data_dir, **kw)
                         ).derive().validate()


def _port_model(start, cfg):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(start[3], strict=True)
    return model


def _port_run(start, data_dir, ckpt, guard=None, **kw):
    cfg = _port_cfg(data_dir, **kw)
    cfg.ckpt_path = ckpt
    os.makedirs(ckpt)
    model = _port_model(start, cfg)
    opt = optim.make_optimizer(model.parameters(), cfg)
    sched = optim.ReduceLROnPlateau(cfg.lr)
    loaders = main_missing.make_loaders(cfg, "cpu")
    history = main_missing.train(cfg, model, opt, loaders, -1, sched,
                                 guard=guard or PreemptionGuard(),
                                 device="cpu")
    return model, opt, sched, loaders, history


def _compare_runs(jdir, pdir, jstate, jsched, model, sched, start_sd):
    jhead, jrows = _read_stat(os.path.join(jdir, "stat.csv"))
    phead, prows = _read_stat(os.path.join(pdir, "stat.csv"))
    assert phead == jhead
    assert [r[0] for r in prows] == [r[0] for r in jrows]
    for (info, g), (_, w) in zip(prows, jrows):
        np.testing.assert_allclose(g, w, rtol=STAT_RTOL, atol=STAT_ATOL,
                                   err_msg=info)
    want = from_jax_params(jax.tree.map(np.asarray, jstate.params),
                           jax.tree.map(np.asarray, jstate.batch_stats),
                           modality_num=M, input_size=(H, W))
    got = model.state_dict()
    assert set(got) == set(want)
    num = den = 0.0
    for k, w in want.items():
        if "running" in k:
            err = float((got[k] - w).abs().max())
            assert err <= BN_STAT_REL * float(w.abs().max()), k
            continue
        # the update each side made: Adam normalizes every gradient, so a
        # near-zero one (a bias before a BatchNorm) moves by noise
        dj, dp = w - start_sd[k], got[k] - start_sd[k]
        n, dd = float((dp - dj).norm()), float(dj.norm())
        assert n <= UPDATE_REL * dd + 1e-12, (k, n, dd)
        num, den = num + n * n, den + dd * dd
    assert (num / den) ** 0.5 <= UPDATES_REL
    got_s, want_s = sched.state_dict(), jsched.state_dict()
    assert (got_s["lr"], got_s["num_bad_epochs"]) == \
        (want_s["lr"], want_s["num_bad_epochs"])
    assert got_s["best"] == pytest.approx(want_s["best"], rel=STAT_RTOL)
    names = sorted(n for n in os.listdir(jdir) if n.endswith(".ckpt"))
    assert sorted(n for n in os.listdir(pdir) if n.endswith(".ckpt")) == names
    for name in names:
        assert int(checkpoint.load_checkpoint(pdir, name)["epoch"]) == \
            int(jckpt.load_checkpoint(jdir, name)["epoch"]), name


def _drop_checkpoints(*dirs):
    for d in dirs:
        for name in os.listdir(d):
            if name.endswith(".ckpt"):
                os.remove(os.path.join(d, name))


def test_device_run_matches_jax(start, data_dir, tmp_path, z_is_the_mean):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstate, jsched, jl = _jax_run(start, data_dir, jdir)
    model, opt, sched, pl, history = _port_run(start, data_dir, pdir)
    assert type(jl[0]).__name__ == type(pl[0]).__name__ == \
        "DeviceBatchLoader"
    try:
        _compare_runs(jdir, pdir, jstate, jsched, model, sched, start[3])
        assert [r["epoch"] for r in history] == [0, 1]
        assert all(r["steps"] == 2 for r in history)
        assert float(opt.state_dict()["state"][0]["step"]) == 4.0
        assert os.path.isdir(os.path.join(pdir, "result_val"))
        assert history[-1]["ckpt_bytes"] == os.path.getsize(
            os.path.join(pdir, "epoch001.ckpt"))
    finally:
        _drop_checkpoints(jdir, pdir)


def test_preemption_and_resume(start, data_dir, tmp_path, monkeypatch):
    """run() preempted after the first chunk of epoch 0, resumed from
    preempt.ckpt through both epochs, then resumed from epoch001.ckpt for a
    third epoch."""
    monkeypatch.setattr(main_missing, "build_model",
                        lambda cfg, device: _port_model(start, cfg))
    store = VolumeStore(os.path.join(data_dir, "BraTS_All_zscore_10.h5"))
    root = str(tmp_path)
    guard = PreemptionGuard()
    guard.request()
    first = main_missing.run(_port_cfg(data_dir, epoch_chunk_steps=1), root,
                             device="cpu", store=store, guard=guard)
    d = first["ckpt_path"]
    assert first["loader"] == "device" and first["cache_bytes"] > 0
    assert first["epochs"] == [{"epoch": 0, "preempted_after_steps": 1,
                                "steps": 2}]
    assert sorted(os.listdir(d)) == ["config.txt", "config.yaml",
                                     PREEMPT_NAME, PREEMPT_NAME + ".epoch"]
    with open(os.path.join(d, PREEMPT_NAME + ".epoch")) as f:
        assert f.read() == "-1"
    name, pre = latest_resume_checkpoint(d, "model_best.ckpt")
    assert name == PREEMPT_NAME and pre["epoch"] == -1 and pre["stat"] == {}
    step = lambda c: float(c["opt_state"]["state"][0]["step"])
    assert step(pre) == 1.0

    label = os.path.basename(d)
    second = main_missing.run(
        _port_cfg(data_dir, continue_train=True, ckpt_timelabel=label),
        root, device="cpu", store=store)
    assert second["ckpt_path"] == d and second["resume_name"] == PREEMPT_NAME
    assert second["start_epoch"] == -1
    assert second["restored"][0] == second["restored"][1] > 0
    assert [r["epoch"] for r in second["epochs"]] == [0, 1]
    assert not os.path.exists(os.path.join(d, PREEMPT_NAME))
    e1 = checkpoint.load_checkpoint(d, "epoch001.ckpt")
    assert step(e1) == 5.0                 # 1 before the preemption, 2 + 2

    third = main_missing.run(
        _port_cfg(data_dir, continue_train=True, ckpt_timelabel=label,
                  ckpt_name="epoch001.ckpt", epochs=3, load_yaml=False),
        root, device="cpu", store=store)
    assert third["resume_name"] == "epoch001.ckpt"
    assert third["start_epoch"] == 1
    assert third["restored"][0] == third["restored"][1]
    assert third["scheduler_at_start"] == e1["scheduler"]
    assert [r["epoch"] for r in third["epochs"]] == [2]
    e2 = checkpoint.load_checkpoint(d, "epoch002.ckpt")
    assert step(e2) == 7.0 and e2["epoch"] == 2
    with open(os.path.join(d, "stat.csv")) as f:
        infos = [line.split(",")[1] for line in f][1:]
    assert infos == ["epoch[ 0]", "val", "epoch[ 1]", "val", "epoch[ 2]",
                     "val"]
    _drop_checkpoints(d)


def test_main_trains_from_a_yaml_file(data_dir, tmp_path):
    """``main([config.yaml, ...])`` reads the HDF5 file and the fold txts
    under ``data_path`` and trains one epoch on the CPU."""
    yaml_path = tmp_path / "config.yaml"
    yaml_path.write_text(
        "phase: 'train'\nepochs: 1\ncontrast_list: ['T1', 'T2']\n"
        f"data_path: '{data_dir}'\ninput_height: {H}\ninput_width: {W}\n"
        f"batch_size: {B}\neffective_batch: {B}\nremat: False\n"
        "others: {'mod_enc_s': False, 'ana_dec_act': 'softmax', "
        "'old': False, 'softmax_remove_mask': True}\n")
    out = main_missing.main([str(yaml_path), "--ckpt-root",
                             str(tmp_path / "ckpt")], device="cpu")
    d = out["ckpt_path"]
    assert out["loader"] == "device" and len(out["epochs"]) == 1
    assert out["epochs"][0]["steps"] == 4          # 8 slices at B=2
    assert {"config.txt", "config.yaml", "epoch000.ckpt", "model_best.ckpt",
            "stat.csv", "result_val"} == set(os.listdir(d))
    _drop_checkpoints(d)


def test_test_phase_and_unported_epoch_options_raise(data_dir, tmp_path):
    """The test phase of a run without a checkpoint raises, as JAX's, after
    resolving the run directory (its config snapshot) and before writing
    any result; tests/test_torch_test_phase.py runs the phase itself."""
    with pytest.raises(ValueError, match="No correct checkpoint"):
        main_missing.run(_port_cfg(data_dir, phase="test"), str(tmp_path),
                         device="cpu")
    (run_dir,) = [d for d, _, files in os.walk(tmp_path) if files]
    assert os.listdir(run_dir) == ["config.yaml"]
    # the adversarial epoch is ported, and needs the discriminator's Adam
    with pytest.raises(ValueError, match="discriminator's optimizer"):
        main_missing.make_train_epoch(
            None, _port_cfg(data_dir, lambda_adv_s=0.1), None, None, None)


def test_over_budget_cache_takes_the_host_loader(data_dir):
    cfg = _port_cfg(data_dir, device_cache_budget_gb=1e-6)
    loaders = main_missing.make_loaders(cfg, "cpu")
    assert [type(ld).__name__ for ld in loaders] == ["BatchLoader"] * 3
    loaders = main_missing.make_loaders(_port_cfg(data_dir), "cpu")
    assert [type(ld).__name__ for ld in loaders] == ["DeviceBatchLoader"] * 3
