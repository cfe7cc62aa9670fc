"""The port's data layer against the JAX package's, on the CPU, with no
model: the synthetic data, fold parsing and splits, the slice datasets,
the host ``BatchLoader``, the device volume cache's gather and loader, and
the epoch plan.  Inputs: the JAX package's synthetic HDF5 data (BraTS, T1
and T2, 32x64x16, one contrast absent in about a third of the subjects),
made from a seed.

Tolerance: none.  Every batch, index, dropoff draw and pair must be
exactly equal (the bf16 cache rounds to nearest even on both sides)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.data import dataset as jds
from representation_disentanglement_tpu.data import device_store as jdev
from representation_disentanglement_tpu.data.loader import (
    BatchLoader as JaxBatchLoader)
from representation_disentanglement_tpu.data.synthetic import (
    make_synthetic_dataset as jax_make_synthetic)
from representation_disentanglement_tpu.training import epoch as jepoch
from representation_disentanglement_torch.data import dataset as ds
from representation_disentanglement_torch.data import device_store as dev
from representation_disentanglement_torch.data import synthetic
from representation_disentanglement_torch.data.loader import BatchLoader
from representation_disentanglement_torch.training.epoch import (
    epoch_indices)

h5py = pytest.importorskip("h5py")

SHAPE = (32, 64, 16)
CONTRASTS = ("T1", "T2")
H5 = "BraTS_All_zscore_10.h5"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jaxdata"))
    jax_make_synthetic(d, "BraTS", CONTRASTS, "z-score", n_subj=7,
                       shape=SHAPE, slice_range=(1, 13), seed=4,
                       missing_prob=0.3)
    return d


@pytest.fixture(scope="module")
def stores(data_dir):
    path = os.path.join(data_dir, H5)
    return jds.VolumeStore(path), ds.VolumeStore(path)


def _train_split(data_dir):
    return ds.load_idx_list(os.path.join(data_dir,
                                         "fold_BraTS_0_train_noval.txt"))


def _assert_batches_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert set(got) == set(want)
    for k in want:
        if k == "subj_id":
            assert list(got[k]) == list(want[k])
        else:
            g = got[k].cpu().numpy() if torch.is_tensor(got[k]) else got[k]
            np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


def test_synthetic_dataset_matches_jax(data_dir, tmp_path):
    d = str(tmp_path)
    synthetic.make_synthetic_dataset(d, "BraTS", CONTRASTS, "z-score",
                                      n_subj=7, shape=SHAPE,
                                      slice_range=(1, 13), seed=4,
                                      missing_prob=0.3)
    names = sorted(os.listdir(data_dir))
    assert sorted(os.listdir(d)) == names
    for name in names:
        if name.endswith(".txt"):
            with open(os.path.join(d, name)) as a, \
                    open(os.path.join(data_dir, name)) as b:
                assert a.read() == b.read(), name
    with h5py.File(os.path.join(d, H5)) as a, \
            h5py.File(os.path.join(data_dir, H5)) as b:
        keys = []
        a.visit(keys.append)
        want = []
        b.visit(want.append)
        assert keys == want
        for k in keys:
            if isinstance(b[k], h5py.Dataset):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k][()], b[k][()])
    vol, brain = synthetic.phantom_volume(np.random.default_rng(0), SHAPE)
    from representation_disentanglement_tpu.data.synthetic import (
        phantom_volume)
    jvol, jbrain = phantom_volume(np.random.default_rng(0), SHAPE)
    np.testing.assert_array_equal(vol, jvol)
    np.testing.assert_array_equal(brain, jbrain)


def test_fold_txts_and_data_all_splits_match_jax(data_dir, stores):
    for split in ("train", "val", "test"):
        path = os.path.join(data_dir, f"fold_BraTS_0_{split}_noval.txt")
        for got, want in zip(ds.load_idx_list(path),
                             jds.load_idx_list(path)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    kw = dict(norm_type="z-score", contrast_list=CONTRASTS,
              image_size=SHAPE[:2], dropoff=True, seed=3)
    jdata = jds.DataAll("BraTS", data_dir, **kw)
    from_file = ds.DataAll("BraTS", data_dir, **kw)
    from_store = ds.DataAll("BraTS", data_dir, store=stores[1], **kw)
    for port in (from_file, from_store):
        for name in ("train_dataset", "val_dataset", "test_dataset"):
            a, b = getattr(port, name), getattr(jdata, name)
            np.testing.assert_array_equal(a.subj_list, b.subj_list)
            np.testing.assert_array_equal(a.idx_list, b.idx_list)
            assert (a.dropoff, a.aug) == (b.dropoff, b.aug)
    assert from_store.store is stores[1]


@pytest.mark.parametrize("dropoff", [False, True])
def test_slice_dataset_matches_jax(data_dir, stores, dropoff):
    subjs, idxs = _train_split(data_dir)
    mk = lambda mod, store: mod.SliceDataset(
        "BraTS", store, subjs, idxs, block_size=3, contrast_list=CONTRASTS,
        dropoff=dropoff, image_size=SHAPE[:2], rng=np.random.default_rng(5))
    jset, pset = mk(jds, stores[0]), mk(ds, stores[1])
    assert len(pset) == len(jset)
    for i in range(len(jset)):
        _assert_batches_equal(pset[i], jset[i])
    sel = [3, 0, 17, 9, len(jset) - 1]
    _assert_batches_equal(pset.get_batch(sel), jset.get_batch(sel))
    got = pset.get_batch(list(range(len(pset))))
    assert got["mask"].min() == 0.0          # an absent contrast is covered
    assert got["slice_idx"].min() == 3       # the low clamp is covered


@pytest.mark.parametrize("shuffle,drop_last,prefetch,per_sample", [
    (True, True, 2, False), (False, False, 2, False), (True, False, 0, True),
    (False, True, 2, True)])
def test_batch_loader_matches_jax(data_dir, stores, shuffle, drop_last,
                                  prefetch, per_sample):
    """``per_sample`` hides ``get_batch``, so the loaders collate
    ``__getitem__`` samples and skip a None one."""
    subjs, idxs = _train_split(data_dir)

    def dataset(mod, store):
        d = mod.SliceDataset("BraTS", store, subjs, idxs,
                             contrast_list=CONTRASTS, dropoff=True,
                             image_size=SHAPE[:2],
                             rng=np.random.default_rng(8))
        if not per_sample:
            return d

        class PerSample:
            def __len__(self):
                return len(d)

            def __getitem__(self, i):
                return None if i == 5 else d[i]
        return PerSample()

    want = list(JaxBatchLoader(dataset(jds, stores[0]), 3, shuffle=shuffle,
                               drop_last=drop_last, seed=2,
                               prefetch=prefetch, to_device=False))
    got = list(BatchLoader(dataset(ds, stores[1]), 3, shuffle=shuffle,
                           drop_last=drop_last, seed=2, prefetch=prefetch))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_batch_loader_to_device_and_worker_error(data_dir, stores):
    subjs, idxs = _train_split(data_dir)
    pset = ds.SliceDataset("BraTS", stores[1], subjs, idxs,
                           contrast_list=CONTRASTS, image_size=SHAPE[:2])
    batch = next(iter(BatchLoader(pset, 4, device="cpu")))
    assert torch.is_tensor(batch["inputs"])
    assert batch["inputs"].shape == (2, 4) + SHAPE[:2] + (7,)

    class Broken:
        def __len__(self):
            return 4

        def get_batch(self, idx):
            raise OSError("unreadable volume")

    with pytest.raises(OSError, match="unreadable"):
        list(BatchLoader(Broken(), 2))


def test_batch_loader_early_stop_ends_the_worker(data_dir, stores):
    import threading
    subjs, idxs = _train_split(data_dir)
    pset = ds.SliceDataset("BraTS", stores[1], subjs, idxs,
                           contrast_list=CONTRASTS, image_size=SHAPE[:2])
    before = threading.active_count()
    it = iter(BatchLoader(pset, 2, prefetch=1))
    next(it)
    it.close()
    assert threading.active_count() == before


def _caches(stores, subjs, dtype):
    jdt, pdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jc = jdev.build_device_cache("BraTS", stores[0], subjs, CONTRASTS,
                                 block_size=3, dtype=jdt, clamp_max=155)
    pc = dev.build_device_cache("BraTS", stores[1], subjs, CONTRASTS,
                                block_size=3, dtype=pdt, clamp_max=155,
                                device="cpu")
    return jc, pc


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_blocks_matches_jax(data_dir, stores, dtype):
    subjs, idxs = _train_split(data_dir)
    jc, pc = _caches(stores, subjs, dtype)
    assert pc.subjects == jc.subjects and pc.clamp_hi == jc.clamp_hi
    assert pc.nbytes == jc.nbytes
    assert pc.vols.dtype == {"f32": torch.float32,
                             "bf16": torch.bfloat16}[dtype]
    rs = np.random.default_rng(1)
    S = len(pc.subjects)
    rows = rs.integers(0, S, 6)
    slices = np.array([3, 12, 7, 3, 9, 12])        # both ends of the clamp
    drop = np.ones((6, 2), np.float32)
    drop[1, 0] = drop[4, 1] = 0.0
    want = jdev.gather_blocks(jc.vols, jc.tgts, jc.presence,
                              jnp.asarray(rows, jnp.int32),
                              jnp.asarray(slices, jnp.int32),
                              jnp.asarray(drop), block_size=3)
    got = dev.gather_blocks(pc.vols, pc.tgts, pc.presence,
                            torch.from_numpy(rows), torch.from_numpy(slices),
                            torch.from_numpy(drop), block_size=3)
    _assert_batches_equal(got, jax.tree.map(np.asarray, want))
    assert got["inputs"].dtype == torch.float32


def test_device_batch_loader_matches_jax(data_dir, stores):
    subjs, idxs = _train_split(data_dir)
    jc, pc = _caches(stores, subjs, "bf16")
    kw = dict(batch_size=4, shuffle=True, drop_last=False, dropoff=True,
              seed=6)
    jl = jdev.DeviceBatchLoader(jc, subjs, idxs, **kw)
    pl = dev.DeviceBatchLoader(pc, subjs, idxs, **kw)
    assert len(pl) == len(jl)
    for _ in range(2):                       # the RNG carries across epochs
        want = [jax.tree.map(np.asarray, b) for b in jl]
        got = list(pl)
        assert len(got) == len(want) == len(jl)
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
    assert any(float(b["mask"].min()) == 0.0 for b in got)


def test_device_cache_budget_returns_none(data_dir, stores):
    subjs, _ = _train_split(data_dir)
    assert dev.build_device_cache("BraTS", stores[1], subjs, CONTRASTS,
                                  budget_bytes=10, device="cpu") is None


@pytest.mark.parametrize("n_micro,modalities", [(2, 2), (1, 4)])
def test_epoch_indices_match_jax(data_dir, stores, n_micro, modalities):
    subjs, idxs = _train_split(data_dir)
    jc, pc = _caches(stores, subjs, "f32")
    kw = dict(batch_size=3, shuffle=True, drop_last=True, dropoff=True,
              seed=9)
    jl = jdev.DeviceBatchLoader(jc, subjs, idxs, **kw)
    pl = dev.DeviceBatchLoader(pc, subjs, idxs, **kw)
    jrng, prng = np.random.default_rng(12), np.random.default_rng(12)
    key = jax.random.PRNGKey(0)
    for _ in range(2):
        (rows, slices, drop, _, sim, adv), key = jepoch.epoch_indices(
            jl, n_micro, modalities, jrng, key)
        plan = epoch_indices(pl, n_micro, modalities, prng)
        np.testing.assert_array_equal(plan.rows.numpy(), np.asarray(rows))
        np.testing.assert_array_equal(plan.slices.numpy(),
                                      np.asarray(slices))
        np.testing.assert_array_equal(plan.drop.numpy(), np.asarray(drop))
        np.testing.assert_array_equal(plan.sim, np.asarray(sim))
        np.testing.assert_array_equal(plan.adv, np.asarray(adv))
        assert plan.drop.dtype == torch.float32
        assert plan.steps == rows.shape[0] == len(subjs) // (3 * n_micro)
        assert plan.chunk(1, 2).rows.shape[0] == 1
    assert float(plan.drop.min()) == 0.0     # a dropoff draw is covered
    small = dev.DeviceBatchLoader(pc, subjs[:2], idxs[:2], batch_size=3)
    assert epoch_indices(small, 1, modalities, prng) is None
