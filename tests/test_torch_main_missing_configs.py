"""The adversarial and the stage-2 configurations through the port's
training run, on the CPU:

- the device-cache epoch (``training/epoch.py``) equals the per-step loop
  of ``make_train_step`` over the same epoch plan, whole and in chunks, in
  the EVERYTHING configuration with the s discriminator (the gradient
  carry crosses the steps and the chunks) and under the stage-2 freeze, as
  tests/test_epoch_loop.py holds the JAX package's scan against its step;
  the step itself is held against the JAX package's in
  tests/test_torch_train_configs{,_y}.py;
- the discriminator's Adam through a checkpoint (``opt_d_state``) and
  ``restore_optimizers``; the gradient carry is not saved;
- a stage-2 ``run`` resumed from a stage-1 run directory whose output
  layer has one channel.

Model as tests/test_torch_train_configs.py (M=2: T1 and T2, 32x64, B=2,
two microbatches per step, plain convolutions); data: the synthetic BraTS
volumes (32x64x20, their seg labels as targets) with 12 train slices, so
that an epoch is 3 optimizer steps, through the device volume cache (f32).
The epoch and the per-step loop run the same arithmetic: they agree to
rtol 1e-6 (measured: equal).
"""

import os

import numpy as np
import pytest
import torch

from representation_disentanglement_torch import config, main_missing
from representation_disentanglement_torch.data import dataset, device_store
from representation_disentanglement_torch.data.synthetic import (
    make_synthetic_dataset)
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.training import (
    checkpoint, epoch, optim, train)
from representation_disentanglement_torch.training.train import (
    is_stage1_param)
from tests.test_torch_train_configs import (  # noqa: F401
    A, B, BASE, EVERYTHING, M, few_threads)
from tests.test_torch_train_configs_y import STAGE2

pytest.importorskip("h5py")

H, W, D = 32, 64, 20
CONTRASTS = ["T1", "T2"]
H5 = "BraTS_All_zscore_10.h5"
STEPS = 3
VARIANTS = {"adversarial": dict(EVERYTHING, contrast_list=CONTRASTS),
            "stage2": dict(STAGE2, contrast_list=CONTRASTS)}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Three subjects: 12 train slices (3 steps of A*B = 4), 4 val, 2
    test."""
    d = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(d, "BraTS", CONTRASTS, "z-score", n_subj=3,
                           shape=(H, W, D), seed=2)
    subjects = [f"BraTS20_Training_{i:03d}" for i in range(3)]
    for split, subj, slices in (("train", subjects[0], range(4, 16)),
                                ("val", subjects[1], range(5, 9)),
                                ("test", subjects[2], range(6, 8))):
        with open(os.path.join(d, f"fold_BraTS_0_{split}_noval.txt"),
                  "w") as f:
            f.writelines(f"{subj} {s}\n" for s in slices)
    return d


def _cfg(data_dir, **kw):
    d = dict(BASE, contrast_list=CONTRASTS, data_path=data_dir)
    d.update(kw)
    return config.Config(**d).derive().validate()


def _plan(data_dir):
    """The train cache (f32) and the plan of one epoch."""
    subjs, idxs = dataset.load_idx_list(
        os.path.join(data_dir, "fold_BraTS_0_train_noval.txt"))
    cache = device_store.build_device_cache(
        "BraTS", dataset.VolumeStore(os.path.join(data_dir, H5)), subjs,
        CONTRASTS, block_size=3, dtype=torch.float32, device="cpu")
    loader = device_store.DeviceBatchLoader(cache, subjs, idxs, B,
                                            shuffle=True, drop_last=True,
                                            seed=3)
    plan = epoch.epoch_indices(loader, A, M, np.random.default_rng(4))
    assert plan.steps == STEPS
    return cache, plan


def _trainer(cfg, sd):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    opt = optim.make_optimizer(model.parameters(), cfg)
    dopt = optim.make_d_optimizer(model.parameters(), cfg) \
        if cfg.is_discrim_s else None
    return model, opt, dopt


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_device_epoch_equals_the_per_step_loop(data_dir, variant):
    cfg = _cfg(data_dir, **VARIANTS[variant])
    sd = build_model(cfg, device="cpu").state_dict()
    cache, plan = _plan(data_dir)
    runs = {}
    for how in ("epoch", "chunks", "steps"):
        model, opt, dopt = _trainer(cfg, sd)
        if how == "steps":
            step = train.make_train_step(model, cfg, opt, dopt)
            rows = []
            for i in range(STEPS):
                mbs = [device_store.gather_blocks(
                    cache.vols, cache.tgts, cache.presence, plan.rows[i, a],
                    plan.slices[i, a], plan.drop[i, a]) for a in range(A)]
                stacked = {k: torch.stack([mb[k] for mb in mbs])
                           for k in ("inputs", "targets", "mask",
                                     "mask_img")}
                rows.append(step(stacked, None, plan.sim[i], plan.adv[i],
                                 first_of_epoch=(i == 0)))
            metrics = torch.stack(rows)
        else:
            train_epoch, n_micro = epoch.make_train_epoch(
                model, cfg, opt, cache, None, dopt)
            assert n_micro == A
            cuts = [0, STEPS] if how == "epoch" else [0, 1, STEPS]
            metrics = torch.cat([train_epoch(plan.chunk(lo, hi), lo == 0)
                                 for lo, hi in zip(cuts, cuts[1:])])
        runs[how] = (model, metrics)
    want_model, want = runs["steps"]
    for how in ("epoch", "chunks"):
        model, got = runs[how]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        for (name, p), q in zip(model.named_parameters(),
                                want_model.parameters()):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=0, msg=name)
    m = train.metrics_to_dict(want[-1])
    if variant == "adversarial":
        assert m["adv_s"] > 0 and m["adv_s_d"] > 0 and m["kl"] > 0
    else:
        assert m["recon_y"] > 0 and m["recon_y_fused"] > 0
        for name, p in want_model.named_parameters():
            if is_stage1_param(name):
                assert torch.equal(p.detach(), sd[name]), name


def test_checkpoint_holds_the_discriminator_optimizer(data_dir, tmp_path):
    """``opt_d_state`` is saved beside ``opt_state`` and
    ``restore_optimizers`` loads both; the gradient carry is not saved, as
    in the JAX package."""
    cfg = _cfg(data_dir, lambda_adv_s=0.1)
    model, opt, dopt = _trainer(cfg, build_model(cfg, device="cpu")
                                .state_dict())
    cache, plan = _plan(data_dir)
    train_epoch, _ = epoch.make_train_epoch(model, cfg, opt, cache, None,
                                            dopt)
    train_epoch(plan.chunk(0, 2), True)
    sched = optim.ReduceLROnPlateau(cfg.lr)
    payload = main_missing._checkpoint(0, 1.0, {}, model, opt, sched, dopt)
    assert set(payload) == {"epoch", "monitor_metric", "stat", "params",
                            "opt_state", "opt_d_state", "scheduler"}
    d = str(tmp_path)
    checkpoint.save_checkpoint(payload, False, d, name="adv.ckpt")
    ckpt = checkpoint.load_checkpoint(d, "adv.ckpt")
    step = lambda o: float(o.state_dict()["state"][0]["step"])
    _, opt2, dopt2 = _trainer(cfg, model.state_dict())
    assert main_missing.restore_optimizers(ckpt, opt2, dopt2)
    assert step(opt2) == step(dopt2) == 2.0
    assert dopt2.param_groups[0]["weight_decay"] == 0.0
    for p, q in zip(dopt.state.values(), dopt2.state.values()):
        torch.testing.assert_close(p["exp_avg"], q["exp_avg"], rtol=0,
                                   atol=0)
    # a run without the discriminator saves None and restores the rest
    plain = main_missing._checkpoint(0, 1.0, {}, model, opt, sched)
    assert plain["opt_d_state"] is None
    assert main_missing.restore_optimizers(plain, opt2, None)
    os.remove(os.path.join(d, "adv.ckpt"))


def test_stage2_run_resumes_a_stage1_run_directory(data_dir, tmp_path):
    """A stage-1 checkpoint (the shipped losses, ``out_num_ch`` 1) in a run
    directory; stage 2 (``load_yaml: False``) resumes it: the shape-tolerant
    merge restores every tensor but the output layer's, so the optimizer is
    not loaded while the schedule and the epoch are, and one epoch runs
    with the stage-1 parameters frozen.  Its val row carries Dice and
    IoU."""
    root = str(tmp_path)
    label = "2026_1_2_3_4"
    d = os.path.join(root, "BraTS", "MultimodalModel", label)
    cfg1 = _cfg(data_dir)
    model1, opt1, _ = _trainer(cfg1, build_model(cfg1, device="cpu")
                               .state_dict())
    sched = optim.ReduceLROnPlateau(cfg1.lr)
    sched.step(1.0)
    checkpoint.save_checkpoint(main_missing._checkpoint(
        0, 1.0, {}, model1, opt1, sched), False, d, name="model_best.ckpt")
    cfg1.snapshot_yaml(d)
    before = checkpoint.load_checkpoint(d, "model_best.ckpt")
    cfg2 = _cfg(data_dir, **VARIANTS["stage2"], load_yaml=False,
                ckpt_timelabel=label, epochs=2)
    store = dataset.VolumeStore(os.path.join(data_dir, H5))
    out = main_missing.run(cfg2, root, device="cpu", store=store)
    try:
        assert out["ckpt_path"] == d
        n_res, n_tot = out["restored"]
        assert n_res == n_tot - 2        # the output conv's weight and bias
        assert not out["optimizer_loaded"]
        assert out["start_epoch"] == 0
        assert out["scheduler_at_start"] == before["scheduler"]
        assert [r["epoch"] for r in out["epochs"]] == [1]
        after = checkpoint.load_checkpoint(d, "epoch001.ckpt")
        frozen = [k for k in after["params"]
                  if is_stage1_param(k) and "running" not in k]
        assert frozen
        for k in frozen:
            assert torch.equal(after["params"][k], before["params"][k]), k
        assert any(not torch.equal(after["params"][k], before["params"][k])
                   for k in after["params"]
                   if k.startswith("output_decoder.") and "running" not in k
                   and after["params"][k].shape == before["params"][k].shape)
        val = out["epochs"][0]["val"]
        assert np.isfinite(val["dice"]) and np.isfinite(val["iou"])
        assert val["recon_y"] > 0 and val["recon_y_fused"] > 0
        with open(os.path.join(d, "stat.csv")) as f:
            rows = [line.rstrip("\n").split(",") for line in f]
        assert [r[1] for r in rows[1:]] == ["epoch[ 1]", "val"]
        np.testing.assert_allclose([float(x) for x in rows[-1][2:]],
                                   [val[k] for k in sorted(val)])
    finally:
        for name in os.listdir(d):
            if name.endswith(".ckpt"):
                os.remove(os.path.join(d, name))
