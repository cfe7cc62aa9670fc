"""The port's host tools against the JAX package's, numpy in and out:
``utils/classification.py`` (bit for bit where both are numpy; the
reconstruction stats through the port's ``metrics.py`` on the CPU),
``data/transforms.py`` (the same ``np.random.Generator`` gives the same
arrays; ``MedicalDataset`` a torch ``Dataset``), ``data/preprocess.py``
(the numeric core bit for bit; the three datasets and the CLI with
``_load_nii`` replaced by phantom arrays, their HDF5 files and fold txts
compared file for file) and ``utils/visualize.py`` (the colour kit bit for
bit, ``save_test_result``'s JPEGs pixel for pixel, the per-volume
metrics)."""

import os
import pickle

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from representation_disentanglement_tpu.data import preprocess as jpre
from representation_disentanglement_tpu.data import transforms as jtr
from representation_disentanglement_tpu.utils import classification as jcls
from representation_disentanglement_tpu.utils import visualize as jvis
from representation_disentanglement_torch.data import preprocess as pre
from representation_disentanglement_torch.data import transforms as tr
from representation_disentanglement_torch.utils import classification as cls
from representation_disentanglement_torch.utils import visualize as vis


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def test_classification_metrics_bit_for_bit():
    rs = np.random.default_rng(0)
    real = (rs.random(500) > 0.6).astype(np.float32)
    fake = (rs.random(500) > 0.5).astype(np.float32)
    scores = np.round(rs.random(500), 1)               # ties
    _same(cls.classification_metrics(real, fake),
          jcls.classification_metrics(real, fake))
    _same(cls.classification_metrics(np.zeros(4), np.zeros(4)),
          jcls.classification_metrics(np.zeros(4), np.zeros(4)))
    assert cls.roc_auc(real, scores) == jcls.roc_auc(real, scores)
    assert np.isnan(cls.roc_auc(np.ones(3), scores[:3]))
    pred = rs.random(96)
    lab = (rs.random(96) > 0.5).astype(np.float32)
    _same(cls.majority_vote_volume_prediction(pred, lab),
          jcls.majority_vote_volume_prediction(pred, lab))
    seg_r = (rs.random((32, 32)) > 0.7).astype(np.float32)
    seg_f = rs.random((32, 32)).astype(np.float32)
    _same(cls.compute_stat(seg_r, seg_f, "segmentation"),
          jcls.compute_stat(seg_r, seg_f, "segmentation"))


def test_compute_stat_reconstruction():
    rs = np.random.default_rng(1)
    real = rs.random((40, 48)).astype(np.float32)
    fake = (real + 0.1 * rs.standard_normal((40, 48))).astype(np.float32)
    got = cls.compute_stat(real, fake, device="cpu")
    want = jcls.compute_stat(real, fake)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def test_transforms_same_draws():
    x = np.random.default_rng(2).random((40, 36, 4)).astype(np.float32)
    for make in (lambda m, g: m.AddNoise(0.2, rng=g),
                 lambda m, g: m.Dropoff(rng=g),
                 lambda m, g: m.Compose([m.AddNoise(rng=g), m.Dropoff(rng=g),
                                         m.CenterCropAndPad((64, 32))])):
        t, j = (make(m, np.random.default_rng(3)) for m in (tr, jtr))
        for _ in range(4):
            _same(t(x), j(x))
    for size in ((64, 64), (32, 32), (64, 32)):
        _same(tr.CenterCropAndPad(size)(x), jtr.CenterCropAndPad(size)(x))
    _same(tr.Tile(3)(x[..., :1]), jtr.Tile(3)(x[..., :1]))
    _same(tr.Dropoff()(x[..., :1]), x[..., :1])
    with pytest.raises(ValueError, match="32"):
        tr.CenterCropAndPad((40, 32))(x)


def test_medical_dataset(tmp_path):
    rs = np.random.default_rng(4)
    samples = [{"input": rs.random((32, 32, 4)), "target":
                rs.random((32, 32, 1)), "label": i % 2} for i in range(3)]
    path = tmp_path / "samples.pkl"
    path.write_bytes(pickle.dumps(samples))
    for task in ("reconstruction", "autoencoding", "classification"):
        t = tr.MedicalDataset(str(path), task, transform=tr.AddNoise(
            rng=np.random.default_rng(5)))
        j = jtr.MedicalDataset(str(path), task, transform=jtr.AddNoise(
            rng=np.random.default_rng(5)))
        assert isinstance(t, torch.utils.data.Dataset) and len(t) == 3
        for i in range(3):
            _same(t[i], j[i])
    batch = next(iter(torch.utils.data.DataLoader(
        tr.MedicalDataset(str(path)), batch_size=3)))
    assert batch["input"].shape == (3, 32, 32, 3)


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------

def test_preprocess_core_bit_for_bit(tmp_path):
    rs = np.random.default_rng(6)
    img = rs.random((24, 20, 6)).astype(np.float32) - 0.3
    img[0, 0, 0] = np.nan
    _same(pre.zscore_brain(img), jpre.zscore_brain(img))
    brain = rs.random(img.shape) > 0.5
    _same(pre.zscore_brain(img, brain), jpre.zscore_brain(img, brain))
    _same(pre.zscore_brain(np.zeros((4, 4, 2))),
          jpre.zscore_brain(np.zeros((4, 4, 2))))
    vol = rs.random((240, 240, 8)).astype(np.float32)
    _same(pre.crop_brats(vol), jpre.crop_brats(vol))
    deep = rs.random((240, 240, 96)).astype(np.float32)
    _same(pre.crop_ncanda(deep), jpre.crop_ncanda(deep))
    _same(pre.pad_zerodose(vol[:157, :189]), jpre.pad_zerodose(vol[:157, :189]))
    subs = [f"s{i}" for i in range(13)]
    for kw in (dict(), dict(num_fold=3, seed=4, val_frac=0.2)):
        _same(pre.make_folds(subs, (50, 53), **kw),
              jpre.make_folds(subs, (50, 53), **kw))
    folds = pre.make_folds(subs, (50, 53))
    name = lambda f, p: f"f{f}_{p}.txt"
    pre.write_fold_txts(folds, str(tmp_path / "t"), name)
    jpre.write_fold_txts(folds, str(tmp_path / "j"), name)
    _same_dirs(tmp_path / "t", tmp_path / "j")


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        if n.endswith(".h5"):
            with h5py.File(a / n) as fa, h5py.File(b / n) as fb:
                keys = []
                fa.visit(keys.append)
                kb = []
                fb.visit(kb.append)
                assert keys == kb
                for k in keys:
                    if isinstance(fa[k], h5py.Dataset):
                        _same(fa[k][()], fb[k][()])
        else:
            assert (a / n).read_bytes() == (b / n).read_bytes(), n


def _phantom_inputs(root, rs):
    """NIfTI-named empty files under ``root`` and the arrays ``_load_nii``
    returns for them (by file name)."""
    arrays = {}

    def put(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "w").close()
        arrays[os.path.basename(path)] = arr

    def vol(shape):
        v = rs.random(shape).astype(np.float32)
        v[:30] = 0.0                                       # background
        return v

    bt = root / "brats"
    for i, shape in enumerate([(240, 240, 155), (240, 240, 155),
                               (240, 240, 100)]):
        subj = f"BraTS20_Training_{i:03d}"
        for suffix in ("t1", "t1ce", "t2", "flair", "seg"):
            if (i, suffix) == (1, "seg"):
                continue                                   # seg optional
            put(str(bt / subj / f"{subj}_{suffix}.nii.gz"),
                vol(shape) if suffix != "seg" else
                rs.integers(0, 5, shape).astype(np.float32))
    nc = root / "ncanda"
    for subj in ("A01", "A02", "A03"):
        for c in ("T1", "T2"):
            if (subj, c) != ("A03", "T2"):                 # A03: T1 only
                put(str(nc / f"{subj}_{c}.nii.gz"), vol((240, 240, 240)))
    zd = root / "zerodose"
    put(str(zd / "mask.nii"), vol((157, 189, 12)) > 0.2)
    for subj in ("case_000", "case_001"):
        for c, f in jpre._ZD_FILES.items():
            if (subj, c) != ("case_001", "ASL"):
                put(str(zd / "vols" / subj / f), vol((157, 189, 10)))
    return arrays


def test_preprocess_datasets_file_for_file(tmp_path, monkeypatch):
    arrays = _phantom_inputs(tmp_path / "in", np.random.default_rng(7))
    load = lambda p: arrays[os.path.basename(p)].astype(np.float32)
    monkeypatch.setattr(pre, "_load_nii", load)
    monkeypatch.setattr(jpre, "_load_nii", load)
    src = tmp_path / "in"
    for name, mod in (("port", pre), ("jax", jpre)):
        out = tmp_path / name
        mod.main(["brats", "--input-dir", str(src / "brats"),
                  "--output-dir", str(out / "brats")])
        mod.preprocess_ncanda(str(src / "ncanda"), str(out / "ncanda"), 3)
        mod.preprocess_zerodose(str(src / "zerodose" / "vols"),
                                str(out / "zerodose"),
                                str(src / "zerodose" / "mask.nii"), 2)
    for d in ("brats", "ncanda", "zerodose"):
        _same_dirs(tmp_path / "port" / d, tmp_path / "jax" / d)
    with h5py.File(tmp_path / "port" / "brats" /
                   "BraTS_All_zscore_10.h5") as f:
        assert sorted(f) == ["BraTS20_Training_000", "BraTS20_Training_001"]
        assert f["BraTS20_Training_000/T1"].shape == (160, 192, 155)
        assert "seg" not in f["BraTS20_Training_001"]


def test_preprocess_gates(monkeypatch, tmp_path):
    monkeypatch.setattr(pre, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        pre.preprocess_brats(str(tmp_path), str(tmp_path))
    try:
        import nibabel  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="nibabel"):
            pre._load_nii(str(tmp_path / "x.nii"))


# ---------------------------------------------------------------------------
# visualize
# ---------------------------------------------------------------------------

def test_colour_kit_bit_for_bit():
    rs = np.random.default_rng(8)
    x = rs.random((17, 13))
    _same(vis.jet_colormap(x), jvis.jet_colormap(x))
    rgb = rs.random((17, 13, 3))
    rgb[0, 0] = 0.5                                       # grey: delta 0
    _same(vis.rgb_to_hsv(rgb), jvis.rgb_to_hsv(rgb))
    _same(vis.hsv_to_rgb(vis.rgb_to_hsv(rgb)),
          jvis.hsv_to_rgb(jvis.rgb_to_hsv(rgb)))
    _same(vis._resize_nearest(x, (40, 30)), jvis._resize_nearest(x, (40, 30)))


@pytest.mark.parametrize("task", ["reconstruction", "segmentation"])
def test_save_test_result_pixels(tmp_path, task):
    rs = np.random.default_rng(9)
    res = {"real_A": rs.random((3, 2, 32, 48)).astype(np.float32),
           "real_B": rs.random((3, 1, 32, 48)).astype(np.float32),
           "fake_B": rs.random((3, 1, 32, 48)).astype(np.float32),
           "alpha_1": rs.random((3, 1, 16, 24)).astype(np.float32),
           "alpha_2": rs.random((3, 1, 8, 12)).astype(np.float32)}
    for name, mod in (("port", vis), ("jax", jvis)):
        mod.save_test_result({k: v.copy() for k, v in res.items()},
                             str(tmp_path / name), bs=2, iteration=1,
                             save_att_maps=True, task=task)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == ["002.jpg", "002_att_maps.jpg", "003.jpg",
                     "003_att_maps.jpg"]
    for n in names:
        a = np.asarray(Image.open(tmp_path / "port" / n))
        b = np.asarray(Image.open(tmp_path / "jax" / n))
        np.testing.assert_array_equal(a, b)


def test_save_test_result_by_volume(tmp_path):
    rs = np.random.default_rng(10)
    real = rs.random((10, 24, 32)).astype(np.float32)
    fake = (real + 0.05 * rs.standard_normal(real.shape)).astype(np.float32)
    got = vis.save_test_result_by_volume(real, fake, str(tmp_path / "p"),
                                         slice_per_subj=4, device="cpu")
    want = jvis.save_test_result_by_volume(real, fake, str(tmp_path / "j"),
                                           slice_per_subj=4)
    assert list(got) == list(want) and len(got["psnr"]) == 2
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
