"""The port's test phase (``main_missing.run`` with ``phase: test``) against
the JAX package's, on the CPU, from one trained run's weights: each package
restores its own checkpoint of the same weights (the port's ``torch.save``
file, JAX's msgpack) and writes ``results_all.h5``; and the port's test
phase on the run directory the JAX package wrote.

Data: the port's synthetic HDF5 file (``data.synthetic``, 4 subjects at
32x64x16, T1 and T2) with fold txts of 8 train slices, 4 val slices and a
test fold of 7 slices from two subjects, so that the test set's last batch
is short (B=2).  Model: tests/test_torch_dump.py's (M=2, f32, plain
convolutions; ``use_pallas: False`` on the JAX side), read through the
device volume cache (bf16, the flagship's) on both sides.

Tolerances (tests/test_torch_dump.py's, with what was measured on a CPU):
the stat dict's losses rtol 1e-4 / atol 1e-7, metrics rtol 1e-4 / atol
1e-6; the dumped model outputs atol 2e-4 (measured at most 7.5e-6); the
inputs, targets, masks, ``subj_id`` and ``slice_idx`` equal.  The
``test_dropoff`` samples and batches of the two packages are equal.
"""

import os
import shutil

import numpy as np
import pytest

from representation_disentanglement_tpu import main_missing as jmain
from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.data import dataset as jdataset
from representation_disentanglement_tpu.training import (
    checkpoint as jckpt)
from representation_disentanglement_torch import config, main_missing
from representation_disentanglement_torch.data import dataset, synthetic
from representation_disentanglement_torch.training import checkpoint
from representation_disentanglement_torch.training.train import LOSS_KEYS
from test_torch_dump import (  # noqa: F401 (few_threads: autouse fixture)
    BASE, assert_dumps_match, assert_stats_match, few_threads, jax_weights,
    port_weights, read_h5)

h5py = pytest.importorskip("h5py")

H, W, D = 32, 64, 16
CONTRASTS = ["T1", "T2"]
LABEL = "2026_1_1_0_0"
SUBJECTS = [f"BraTS20_Training_{i:03d}" for i in range(4)]
FOLDS = {"train": [(SUBJECTS[0], range(4, 12))],
         "val": [(SUBJECTS[1], range(5, 9))],
         "test": [(SUBJECTS[2], range(4, 9)), (SUBJECTS[3], range(6, 8))]}
TEST_ROWS = 7
CFG = dict(BASE, contrast_list=CONTRASTS, phase="test",
           ckpt_timelabel=LABEL)


def make_data(d: str) -> str:
    """The synthetic HDF5 file and the fold txts of FOLDS under ``d``."""
    synthetic.make_synthetic_dataset(d, "BraTS", CONTRASTS, "z-score",
                                     n_subj=len(SUBJECTS), shape=(H, W, D),
                                     seed=2)
    for split, rows in FOLDS.items():
        with open(os.path.join(d, f"fold_BraTS_0_{split}_noval.txt"),
                  "w") as f:
            f.writelines(f"{s} {i}\n" for s, sl in rows for i in sl)
    return d


def make_runs(root: str, sd) -> dict:
    """One trained run's weights as a port checkpoint under
    ``root/port`` and a JAX checkpoint under ``root/jax``, each the
    ``model_best.ckpt`` of run LABEL.  Returns the two ckpt roots."""
    params, stats = jax_weights(sd, len(CONTRASTS), (H, W))
    roots = {k: os.path.join(root, k) for k in ("port", "jax")}
    checkpoint.save_checkpoint({"epoch": 3, "params": sd}, True,
                               run_dir(roots["port"]))
    jckpt.save_checkpoint({"epoch": 3, "params": params,
                           "batch_stats": stats}, True,
                          run_dir(roots["jax"]))
    return roots


def run_dir(ckpt_root: str) -> str:
    return os.path.join(ckpt_root, "BraTS", "MultimodalModel", LABEL)


def port_cfg(data_dir, **kw):
    return config.Config(**dict(CFG, data_path=data_dir, **kw))


def jax_cfg(data_dir, **kw):
    return JaxConfig(**dict(CFG, data_path=data_dir, remat=False,
                            use_pallas=False, **kw))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    data_dir = make_data(str(tmp_path_factory.mktemp("data")))
    roots = make_runs(str(tmp_path_factory.mktemp("ckpt")), port_weights())
    return data_dir, roots


def result(ckpt_root, set_name, info=""):
    return read_h5(os.path.join(run_dir(ckpt_root), "result_" + set_name,
                                "results_all" + info + ".h5"))


@pytest.fixture(scope="module")
def jax_test(setup):
    """JAX's ``--set test`` on its run directory: (stat, dump)."""
    data_dir, roots = setup
    stat = jmain.run(jax_cfg(data_dir), ckpt_root=roots["jax"],
                     eval_set="test")
    return stat, result(roots["jax"], "test")


def test_test_phase_matches_jax(setup, jax_test, capsys):
    """``--set test``: every tensor restored, the stat dict and the whole
    ``results_all.h5`` (7 rows; the stale y of batch 0 appended at each of
    the 4 batches: 8 y rows)."""
    data_dir, roots = setup
    want, ref = jax_test
    got = main_missing.run(port_cfg(data_dir), ckpt_root=roots["port"],
                           device="cpu", eval_set="test")
    assert "restored 242/242 param tensors" in capsys.readouterr().out
    assert_stats_match(got, want)
    port = result(roots["port"], "test")
    assert_dumps_match(port, ref)
    assert port["inputs"].shape[0] == TEST_ROWS
    assert port["y_fake_fused"].shape[0] == 8
    assert port["subj_id"].tolist() == [
        s.encode() for s, sl in FOLDS["test"] for _ in sl]
    assert port["slice_idx"].tolist() == [
        i for _, sl in FOLDS["test"] for i in sl]


def test_test_phase_from_the_jax_run_directory_matches_jax(
        setup, jax_test, tmp_path, capsys):
    """The port's ``--set test`` on the run directory the JAX package
    wrote (its flax msgpack ``model_best.ckpt``, read by the port's own
    reader and converted by ``weights.from_jax_params``), against JAX's
    test phase there, at the tolerances above."""
    data_dir, roots = setup
    want, ref = jax_test
    root = str(tmp_path / "ckpt")
    os.makedirs(run_dir(root))
    shutil.copyfile(os.path.join(run_dir(roots["jax"]), "model_best.ckpt"),
                    os.path.join(run_dir(root), "model_best.ckpt"))
    got = main_missing.run(port_cfg(data_dir), ckpt_root=root, device="cpu",
                           eval_set="test")
    assert "restored 242/242 param tensors" in capsys.readouterr().out
    assert_stats_match(got, want)
    assert_dumps_match(result(root, "test"), ref)


def test_dropoff_dataset_and_loader_match_jax(setup):
    """``TestDropoffDataset`` sample by sample on one data file, and the
    ``test_dropoff`` loaders batch by batch: 2 selected rows (the fold is
    shorter than the reference's selection 438, 450) x 4 drop types at
    M=2."""
    data_dir, _ = setup
    h5_path = os.path.join(data_dir, "BraTS_All_zscore_10.h5")
    subjs, idxs = dataset.load_idx_list(
        os.path.join(data_dir, "fold_BraTS_0_test_noval.txt"))
    kw = dict(block_size=3, contrast_list=CONTRASTS, dataset_name="BraTS",
              image_size=(H, W))
    ours = dataset.TestDropoffDataset(dataset.VolumeStore(h5_path), subjs,
                                      idxs, [0, 5], **kw)
    ref = jdataset.TestDropoffDataset(jdataset.VolumeStore(h5_path), subjs,
                                      idxs, [0, 5], **kw)
    assert len(ours) == len(ref) == 8
    assert ours.drop_type == ref.drop_type == [[], [0], [0, 1], [1]]
    for i in range(len(ref)):
        g, w = ours[i], ref[i]
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")
    got = list(main_missing.make_dropoff_loader(
        port_cfg(data_dir).derive().validate()))
    want = list(jmain.make_dropoff_loader(
        jax_cfg(data_dir).derive().validate()))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("inputs", "targets", "mask", "mask_img", "slice_idx",
                  "subj_id"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_dropoff_test_phase_rows(setup):
    """``--set test_dropoff`` through the port's test phase: 8 rows, each
    selected row under the drop types in order."""
    data_dir, roots = setup
    stat = main_missing.run(port_cfg(data_dir), ckpt_root=roots["port"],
                            device="cpu", eval_set="test_dropoff")
    assert all(np.isfinite(stat[k]) for k in LOSS_KEYS)
    dump = result(roots["port"], "test_dropoff")
    assert dump["inputs"].shape == (8, 2 * 7, H, W)
    np.testing.assert_array_equal(
        dump["mask"], np.tile([[1, 1], [0, 1], [0, 0], [1, 0]], (2, 1)))
    assert not dump["inputs"][2].any() and dump["inputs"][1, :7].sum() == 0
    assert dump["slice_idx"].tolist() == [4] * 4 + [5] * 4


def test_cli_evaluates_the_set_it_names(setup, tmp_path):
    """``main([config.yaml, --set val], device="cpu")``: the val fold's 4
    rows in ``result_val/results_all.h5``, the stat dict returned."""
    data_dir, roots = setup
    yaml_path = tmp_path / "config.yaml"
    yaml_path.write_text(
        f"phase: 'test'\nckpt_timelabel: '{LABEL}'\n"
        "contrast_list: ['T1', 'T2']\n"
        f"data_path: '{data_dir}'\ninput_height: {H}\ninput_width: {W}\n"
        "batch_size: 2\neffective_batch: 2\nis_cond: False\n"
        "others: {'mod_enc_s': False, 'ana_dec_act': 'softmax', "
        "'old': False, 'softmax_remove_mask': True}\n")
    stat = main_missing.main([str(yaml_path), "--ckpt-root", roots["port"],
                              "--set", "val"], device="cpu")
    assert list(stat)[:len(LOSS_KEYS)] == list(LOSS_KEYS)
    dump = result(roots["port"], "val")
    assert dump["inputs"].shape[0] == 4
    assert dump["slice_idx"].tolist() == list(FOLDS["val"][0][1])
