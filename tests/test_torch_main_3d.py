"""The port's 3D entry point (``main_3d``) on the CPU: training with
validation, ``stat.csv`` and checkpoints, ``--resume``, preemption through
a guard, ``--phase test`` with its label volumes, ``--accum``, and the
refusals (no card without ``device="cpu"``, multi-GPU sharding).

Port only (no JAX is compiled; tests/test_torch_train3d.py holds the steps
and the dataset against the JAX package): 5 BraTS phantom subjects from
``data.synthetic`` (3 train, 1 val, 1 test, ``_noval`` fold txts) at
16x16x32 in memory, T1 and T2, a 16x16x16 slab from slice 8,
``init_channels`` 8, batch 1.
"""

import os

import numpy as np
import pytest
import torch

from representation_disentanglement_torch import main_3d
from representation_disentanglement_torch.data import synthetic
from representation_disentanglement_torch.data.dataset import (
    VolumeStore, fold_txt_names)
from representation_disentanglement_torch.data.preprocess import (
    write_fold_txts)
from representation_disentanglement_torch.training import checkpoint
from representation_disentanglement_torch.utils import preempt
from test_torch_dump import few_threads  # noqa: F401 (autouse fixture)

TRAIN_ROWS = ["epoch[ 0]", "epoch[ 1]"]
STAT_KEYS = ["dice_loss", "grad_norm", "kl", "loss", "vae_recon",
             "val_dice"]


@pytest.fixture
def data(tmp_path):
    vols, subjects, _ = synthetic.synthetic_volumes(
        "BraTS", ("T1", "T2"), "z-score", 5, (16, 16, 32), seed=4)
    path = str(tmp_path / "data")
    os.makedirs(path)
    write_fold_txts(
        synthetic.one_fold((subjects[:3], subjects[3:4], subjects[4:])),
        path, synthetic.by_split(fold_txt_names("BraTS", 0, 2)))
    return path, VolumeStore(data=vols), str(tmp_path / "ckpt3d")


def args_for(data, *extra):
    path, _, ckpt = data
    return main_3d.build_parser().parse_args(
        ["--data-path", path, "--contrasts", "T1", "T2", "--init-channels",
         "8", "--image-size", "16", "16", "16", "--slab-start", "8",
         "--ckpt-dir", ckpt, *extra])


def run(data, *extra, guard=None):
    return main_3d.run(args_for(data, *extra), device="cpu", store=data[1],
                       guard=guard)


def read_stat(ckpt):
    import csv
    with open(os.path.join(ckpt, "stat.csv"), newline="") as f:
        head, *rows = list(csv.reader(f))
    return head[2:], [(r[1], [float(v) if v else float("nan")
                              for v in r[2:]]) for r in rows]


def adam_step(ckpt, name):
    state = checkpoint.load_checkpoint(ckpt, name)["opt_state"]["state"]
    return {float(s["step"]) for s in state.values()}


def test_train_two_epochs_then_resume_a_third(data):
    ckpt = data[2]
    out = run(data, "--epochs", "2")
    assert out["start_epoch"] == 0 and out["resume"] is None
    assert [r["epoch"] for r in out["epochs"]] == [0, 1]
    for r in out["epochs"]:
        assert r["steps"] == 3 and np.isfinite(r["train"]["loss"])
        assert 0.0 <= r["val_dice"] <= 1.0
        assert r["ckpt_bytes"] == os.path.getsize(
            os.path.join(ckpt, f"epoch{r['epoch']:03d}.ckpt"))
        assert r["volumes_per_s"] > 0 and r["monitor"] == 1 - r["val_dice"]
    keys, rows = read_stat(ckpt)
    assert keys == STAT_KEYS and [i for i, _ in rows] == TRAIN_ROWS
    assert all(np.isfinite(v) for _, r in rows for v in r)
    for name, epoch in (("epoch000.ckpt", 0), ("epoch001.ckpt", 1)):
        c = checkpoint.load_checkpoint(ckpt, name)
        assert c["epoch"] == epoch and c["monitor_is_val_dice"] == 1
    best = checkpoint.load_checkpoint(ckpt)
    assert best["epoch"] == min(
        out["epochs"], key=lambda r: (r["monitor"], -r["epoch"]))["epoch"]
    assert adam_step(ckpt, "epoch001.ckpt") == {6.0}

    e1 = checkpoint.load_checkpoint(ckpt, "epoch001.ckpt")["params"]
    out = run(data, "--epochs", "3", "--resume")
    assert out["resume"] == {"resume_name": "epoch001.ckpt",
                             "restored": [len(e1), len(e1)],
                             "optimizer_loaded": True}
    assert out["start_epoch"] == 2 and [r["epoch"] for r in
                                        out["epochs"]] == [2]
    assert adam_step(ckpt, "epoch002.ckpt") == {9.0}
    _, rows = read_stat(ckpt)
    assert [i for i, _ in rows] == TRAIN_ROWS + ["epoch[ 2]"]
    # a resume past the last epoch only validates
    out = run(data, "--epochs", "3", "--resume")
    assert out["epochs"] == [] and 0.0 <= out["val_dice"] <= 1.0


def test_preemption_saves_and_resumes(data):
    ckpt = data[2]
    run(data, "--epochs", "1")
    guard = preempt.PreemptionGuard()
    guard.request()
    out = run(data, "--epochs", "3", "--resume", guard=guard)
    assert out["epochs"] == [{"epoch": 1, "preempted_after_steps": 1}]
    with open(preempt.preempt_path(ckpt) + ".epoch") as f:
        assert f.read() == "0"
    pre = checkpoint.load_checkpoint(ckpt, preempt.PREEMPT_NAME)
    assert pre["epoch"] == 0
    assert adam_step(ckpt, preempt.PREEMPT_NAME) == {4.0}
    # the resume prefers preempt.ckpt, replays epoch 1 and clears it once
    # epoch 1 is written
    out = run(data, "--epochs", "2", "--resume")
    assert out["resume"]["resume_name"] == preempt.PREEMPT_NAME
    assert [r["epoch"] for r in out["epochs"]] == [1]
    assert adam_step(ckpt, "epoch001.ckpt") == {7.0}
    assert not os.path.exists(preempt.preempt_path(ckpt))


def test_phase_test_scores_and_exports_label_volumes(data):
    ckpt = data[2]
    run(data, "--epochs", "1")
    out = run(data, "--phase", "test")
    assert out["n_subjects"] == 1 and out["restored"][0] == \
        out["restored"][1] > 0
    (subj, scores), = out["per_subject"].items()
    assert 0.0 <= scores["dice"] <= 1.0 and 0.0 <= scores["iou"] <= 1.0
    assert out["dice"] == scores["dice"] and out["iou"] == scores["iou"]
    path = os.path.join(ckpt, "result_test", f"{subj}_pred.npy")
    assert out["files"] == [path]
    lab = np.load(path)
    assert lab.shape == (16, 16, 16) and lab.dtype == np.float32
    assert set(np.unique(lab)) <= {0.0, 1.0, 2.0, 3.0}
    _, rows = read_stat(ckpt)
    assert [i for i, _ in rows] == ["epoch[ 0]", "test"]
    out = run(data, "--phase", "test", "--no-export",
              "--ckpt-name", "epoch000.ckpt")
    assert out["files"] == [] and out["n_subjects"] == 1


def test_accum_takes_one_step_per_two_volumes(data, capsys):
    out = run(data, "--epochs", "1", "--accum", "2")
    assert out["epochs"][0]["steps"] == 1
    assert "dropping 1 leftover microbatch" in capsys.readouterr().out
    assert adam_step(data[2], "epoch000.ckpt") == {1.0}
    with pytest.raises(ValueError, match="no optimizer step"):
        run(data, "--epochs", "1", "--accum", "4")


@pytest.mark.parametrize("flag", ["--depth-shards", "--data-shards"])
def test_sharding_is_refused_naming_item_16(data, flag):
    """What stays refused of the sharding, as JAX main_3d's checks: a depth
    whose /16 does not divide by the depth shards (16 / 16 = 1 over 2), a
    batch that does not divide by the data shards, and ``--accum``."""
    match = "must divide by --depth-shards" if flag == "--depth-shards" \
        else "must divide by --data-shards"
    with pytest.raises(ValueError, match=match):
        run(data, flag, "2")
    with pytest.raises(ValueError, match="--accum is not supported"):
        run(data, flag, "2", "--accum", "2", "--batch-size", "2",
            "--image-size", "16", "16", "32", "--slab-start", "0")
    assert not os.path.exists(data[2])


@pytest.mark.parametrize("flags", [["--depth-shards", "2"],
                                   ["--data-shards", "2"]],
                         ids=["depth2", "data2"])
def test_sharded_training_runs_on_two_processes(data, flags):
    """Two epochs on 2 gloo processes (a 32-slice slab, batch 2): equal to
    the unsharded run's losses, one ``stat.csv`` row per epoch (rank 0
    writes), and a checkpoint that resumes on one process."""
    extra = ["--epochs", "2", "--batch-size", "2", "--image-size", "16",
             "16", "32", "--slab-start", "0"]
    got = run(data, *extra, *flags)
    want_mesh = [2, 1] if flags[0] == "--data-shards" else [1, 2]
    assert got["mesh"] == want_mesh                  # [data, depth]
    _, rows = read_stat(data[2])
    assert [i for i, _ in rows] == TRAIN_ROWS
    want = run(data[:2] + (data[2] + "_one",), *extra)
    for g, w in zip(got["epochs"], want["epochs"]):
        for k in ("loss", "dice_loss", "vae_recon", "kl"):
            np.testing.assert_allclose(g["train"][k], w["train"][k],
                                       rtol=2e-5, err_msg=k)
        np.testing.assert_allclose(g["val_dice"], w["val_dice"], rtol=1e-5)
    res = run(data, *extra[2:], "--epochs", "3", "--resume")
    assert res["resume"]["restored"][0] == res["resume"]["restored"][1]
    assert res["resume"]["optimizer_loaded"]


def test_main_without_device_refuses_the_cpu(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_3d.main(["--data-path", data[0], "--ckpt-dir", data[2]])
    assert not os.path.exists(data[2])
