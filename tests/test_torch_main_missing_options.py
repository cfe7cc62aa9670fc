"""A training run of the port (``main_missing.run``) in every 2D model
option at once, then its resume, on the CPU; port only (the JAX package
cannot run per-modality encoders, tests/torch_options_common.py).

Configuration: SPADEFull (``shared_inp_dec``), per-modality anatomy and
modality encoders, ``mod_enc_s``, the 'U+SSA+CA' decoder, the fused
BatchNorm and the perceptual similarity (``vgg_pre`` and a random VGG16
npz), at M=2 (T1, T2), 32x64, B=2, f32; data: the port's synthetic BraTS
volumes (32x64x20) in memory, 4 train slices (two optimizer steps), 4 val
and 2 test slices.  One epoch, then ``continue_train`` for a second: every
tensor of the checkpoint is restored, the per-modality lists and
``vgg_pre`` included, and the resumed model starts from exactly the saved
state.
"""

import os

import numpy as np
import pytest
import torch

from representation_disentanglement_torch import config, main_missing
from representation_disentanglement_torch.data.dataset import (
    VolumeStore, fold_txt_names)
from representation_disentanglement_torch.data.synthetic import (
    by_split, one_fold, synthetic_volumes)
from representation_disentanglement_torch.data.preprocess import (
    write_fold_txts)
from representation_disentanglement_torch.training import checkpoint
import torch_options_common as C

two_threads = pytest.fixture(scope="module", autouse=True)(C.two_threads)
CONTRASTS = ["T1", "T2"]


def test_options_run_then_resume(tmp_path, monkeypatch):
    d = str(tmp_path)
    npz = C.write_random_vgg_npz(os.path.join(d, "vgg.npz"))
    vols, subjects, _ = synthetic_volumes("BraTS", CONTRASTS, "z-score", 3,
                                          (C.H, C.W, 20), seed=2)
    write_fold_txts(one_fold(([subjects[0]], [subjects[1]], [subjects[2]]),
                             (6, 10)), d,
                    by_split(fold_txt_names("BraTS", 0, 2)))
    store = VolumeStore(data=vols)
    kw = dict(contrast_list=CONTRASTS, input_height=C.H, input_width=C.W,
              batch_size=C.B, effective_batch=C.B, data_path=d, epochs=1,
              shared_inp_dec=True, shared_ana_enc=False,
              shared_mod_enc=False, target_model_name="U+SSA+CA",
              fuse_bn=True, s_sim_method="perceptual", vgg_npz=npz,
              others=dict(C.OTHERS, mod_enc_s=True), log_every=1)
    root = os.path.join(d, "ckpt")
    first = main_missing.run(config.Config(**kw).derive(), root,
                             device="cpu", store=store)
    run_dir = first["ckpt_path"]
    try:
        assert [r["steps"] for r in first["epochs"]] == [2]
        rec = first["epochs"][0]
        assert all(np.isfinite(v) for v in rec["train"].values())
        assert rec["train"]["sim_s"] != 0.0
        saved = checkpoint.load_checkpoint(run_dir, "model_best.ckpt")
        names = list(saved["params"])
        for prefix in ("anatomy_encoder_enc_list.1.",
                       "modality_encoder_list.1.", "vgg_pre.",
                       "input_decoder_list.0.sp6.",
                       "output_decoder.att_4_s.W_g_diff."):
            assert any(n.startswith(prefix) for n in names), prefix
        assert not any(n.startswith("input_decoder_list.1.") for n in names)
        started = {}
        real_train = main_missing.train

        def capture(cfg, model, *a, **k):
            started.update({n: t.detach().clone()
                            for n, t in model.state_dict().items()})
            return real_train(cfg, model, *a, **k)

        monkeypatch.setattr(main_missing, "train", capture)
        label = os.path.basename(run_dir)
        second = main_missing.run(
            config.Config(**dict(kw, epochs=2, continue_train=True,
                                 load_yaml=False,
                                 ckpt_timelabel=label)).derive(),
            root, device="cpu", store=store)
        assert second["ckpt_path"] == run_dir
        n_res, n_tot = second["restored"]
        assert n_res == n_tot == len(names)
        assert second["optimizer_loaded"] and second["start_epoch"] == 0
        assert second["resume_name"] == "model_best.ckpt"
        assert set(started) == set(saved["params"])
        for n, t in saved["params"].items():
            assert torch.equal(started[n], t), n
        assert [r["epoch"] for r in second["epochs"]] == [1]
    finally:
        for name in os.listdir(run_dir):
            if name.endswith(".ckpt"):
                os.remove(os.path.join(run_dir, name))
