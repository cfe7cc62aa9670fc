"""The port's host gather (``representation_disentanglement_torch/native``)
against the JAX package's ``native.gather_blocks`` and a numpy transpose,
and ``SliceDataset.get_batch`` in both of its branches against JAX's, on
the same in-memory volumes.  Everything here is exact: the gather is a
copy.  Also the loader's switches: ``RDT_NATIVE=0``, no ``g++``, a ``g++``
that fails (raises with its stderr), ``RDT_NATIVE_THREADS``."""

import numpy as np
import pytest

from representation_disentanglement_tpu import native as jnative
from representation_disentanglement_tpu.data import dataset as jdataset
from representation_disentanglement_torch import native
from representation_disentanglement_torch.data import dataset, synthetic
from representation_disentanglement_torch.data.loader import BatchLoader

H, W, D, BC = 16, 24, 20, 7
CONTRASTS = ["T1", "T1c", "T2", "T2_FLAIR"]


def _tasks(seed=0):
    """Four depth-major volumes and 9 tasks: block starts at several depths,
    three zero-filled."""
    rs = np.random.default_rng(seed)
    vols = [np.ascontiguousarray(rs.normal(size=(D, H, W)), np.float32)
            for _ in range(4)]
    starts = [(0, 0), None, (1, 5), (2, 13), None, (3, 2), (0, 9), None,
              (1, 0)]
    ptrs = np.array([0 if t is None else
                     vols[t[0]].ctypes.data + t[1] * H * W * 4
                     for t in starts], np.uint64)
    want = np.stack([np.zeros((H, W, BC), np.float32) if t is None else
                     np.transpose(vols[t[0]][t[1]:t[1] + BC], (1, 2, 0))
                     for t in starts])
    return vols, ptrs, want


@pytest.mark.parametrize("threads", [None, "1", "3"])
def test_gather_blocks_matches_jax_and_numpy(monkeypatch, threads):
    if threads is not None:
        monkeypatch.setenv("RDT_NATIVE_THREADS", threads)
    assert native.available() and jnative.available()
    vols, ptrs, want = _tasks()
    got = np.full((len(ptrs), H, W, BC), np.nan, np.float32)
    native.gather_blocks(ptrs, got)
    ref = np.full_like(got, np.nan)
    jnative.gather_blocks(ptrs, ref)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    del vols


def test_gather_blocks_refuses_a_wrong_output():
    vols, ptrs, _ = _tasks()
    with pytest.raises(ValueError, match="float32"):
        native.gather_blocks(ptrs, np.empty((len(ptrs), H, W, BC)))
    with pytest.raises(ValueError, match="pointers"):
        native.gather_blocks(ptrs[:3], np.empty((4, H, W, BC), np.float32))
    del vols


def _datasets(monkeypatch, use_native: bool, dropoff=False):
    vols, subjects, _ = synthetic.synthetic_volumes(
        "BraTS", CONTRASTS, n_subj=3, shape=(H, W, 155), seed=4,
        missing_prob=0.3)
    subj = np.array([s for s in subjects for _ in range(5)])
    idx = np.array([i for _ in subjects for i in (0, 3, 70, 150, 151)])
    kw = dict(block_size=3, contrast_list=CONTRASTS, image_size=(H, W),
              dropoff=dropoff)
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    ours = dataset.SliceDataset("BraTS", dataset.VolumeStore(data=vols),
                                subj, idx, rng=np.random.default_rng(7),
                                **kw)
    ref = jdataset.SliceDataset("BraTS", jdataset.VolumeStore(data=vols),
                                subj, idx, rng=np.random.default_rng(7),
                                **kw)
    return ours, ref, len(subj)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("dropoff", [False, True])
def test_get_batch_matches_jax(monkeypatch, use_native, dropoff):
    """Both branches, with absent contrasts (zero-filled, mask 0), clamped
    slice indices and the train-time dropoff, batch by batch equal to
    JAX's; the port names the branch it took."""
    ours, ref, n = _datasets(monkeypatch, use_native, dropoff)
    order = np.random.default_rng(1).permutation(n)
    for lo in range(0, n, 4):
        rows = order[lo:lo + 4].tolist()
        got, want = ours.get_batch(rows), ref.get_batch(rows)
        assert ours.gather_branch == ("native" if use_native else "numpy")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    assert ref._packed["native_ok"]                  # JAX took its C++ path
    assert (ours._packed["vols"][next(iter(ours._packed["vols"]))]
            .flags["C_CONTIGUOUS"])


def test_loader_names_the_branch(monkeypatch):
    ours, _, _ = _datasets(monkeypatch, True)
    loader = BatchLoader(ours, 4, prefetch=0)
    assert loader.gather is None
    assert len(list(loader)) == 4
    assert loader.gather == "native"


def test_switches(monkeypatch, tmp_path):
    """RDT_NATIVE=0 and a missing g++ turn the gather off; a g++ that fails
    raises with its stderr, and nothing is loaded."""
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setenv("RDT_NATIVE", "0")
    assert not native.available()
    monkeypatch.delenv("RDT_NATIVE")
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="not available"):
        native.gather_blocks(np.zeros(1, np.uint64),
                             np.empty((1, 2, 2, 1), np.float32))
    monkeypatch.undo()
    bad = tmp_path / "gather.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.available()
    assert "lib" not in native._state
