"""The port's result dump and z retrieval (training/evaluate.py with
``phase="test"``, ``save_res``, ``info``) against the JAX package's
``evaluate``, on the CPU from the same weights and batches.

Model: the flagship structure at M=2 (T1, T1c), 32x64, B=2, f32, with plain
convolutions (``is_cond: False``) and ``use_pallas: False`` on the JAX
side; the port's torch initialization with the zero-initialized biases made
nonzero and non-default running statistics, carried to JAX by
``transplant_multimodal`` (no JAX initialization is compiled).  Three
batches: a full one, one whose second row is padding (``valid`` False) and
a short last one of one row; contrast 0 is missing in one sample.

Both sides run with denormals flushed to zero, as XLA runs on the CPU
(``torch.set_flush_denormal``): a sample whose contrast 0 is missing has
an all-background mask, so its anatomy codes are 0 in JAX and float32
denormals (4e-44) in torch.  Its retrieval query is then the zero vector,
whose cosine similarities are exactly 0 (JAX: the first bank row wins the
tie) or noise of 1e-39 (torch without the flush: another row wins).

Tolerances (tests/test_torch_evaluate.py's, the eval step's), with what was
measured on a CPU: losses rtol 1e-4 / atol 1e-7, metrics rtol 1e-4 /
atol 1e-6; the dumped model outputs (grids, y, s, z, retrieved z) atol
2e-4 (measured at most 7.5e-6, on xi_fake_mix; losses and metrics at most
4.4e-6 relative, on SSIM); the dumped inputs, targets, masks,
``subj_id`` bytes and ``slice_idx``: equal.  A ``mean`` retrieval's z is
the bank mean in f32, rtol 1e-6 (measured equal); a nearest-neighbour
retrieval picks the same bank rows, so its z is equal.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu import losses as jlosses
from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.main_missing import (
    build_model as jax_build_model)
from representation_disentanglement_tpu.training import evaluate as jeval
from representation_disentanglement_tpu.utils.transplant import (
    transplant_multimodal)
from representation_disentanglement_torch import losses
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.training import evaluate
from representation_disentanglement_torch.training.train import LOSS_KEYS

h5py = pytest.importorskip("h5py")

M, B, H, W, CB = 2, 2, 32, 64, 7
BASE = dict(contrast_list=["T1", "T1c"], input_height=H, input_width=W,
            batch_size=B, effective_batch=B, notshared_impl="loop",
            is_cond=False,
            others={"mod_enc_s": False, "ana_dec_act": "softmax",
                    "old": False, "softmax_remove_mask": True})
# a ZeroDose-style y loss on the same model: y every batch, SSIM/PSNR/MSE
# of the fused y
Y_LOSS = dict(dataset_name="ZeroDose", lambda_recon_y=1.0,
              lambda_recon_y_fused=2.0)
LOSS_TOL = dict(rtol=1e-4, atol=1e-7)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
OUT_ATOL = 2e-4
EXACT = ("inputs", "targets", "mask", "subj_id", "slice_idx")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the workers of a parallel test run share the
    cores, and torch's thread pool slows many times over when they are
    oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def flush_denormals():
    """Denormals flushed to zero, as XLA on the CPU (module docstring)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def port_weights(seed: int = 1):
    """The port's state_dict (torch init from ``seed``, zero biases made
    nonzero, running statistics made non-default)."""
    cfg = Config(**BASE).derive().validate()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    rs = np.random.default_rng(7)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith(".bias") and not v.any():
            v = torch.from_numpy(rs.normal(0.0, 0.05, v.shape).astype(
                np.float32))
        elif k.endswith("running_mean"):
            v = torch.from_numpy(rs.normal(0.0, 0.1, v.shape).astype(
                np.float32))
        elif k.endswith("running_var"):
            v = torch.from_numpy(rs.uniform(0.5, 1.5, v.shape).astype(
                np.float32))
        sd[k] = v.clone()
    return sd


def jax_weights(sd, m=M, size=(H, W)):
    params, stats = transplant_multimodal(
        {k: v.numpy() for k, v in sd.items()}, m, size, is_cond=False,
        notshared_impl="loop")
    return (jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, stats))


class Sides:
    """Both packages' models and eval steps for one loss configuration."""

    def __init__(self, pair, root, **kw):
        sd, jmodel, params, stats = pair
        self.cfg = Config(**dict(BASE, **kw)).derive().validate()
        self.cfg.ckpt_path = os.path.join(root, "port")
        self.jcfg = JaxConfig(**dict(BASE, remat=False, use_pallas=False,
                                     **kw)).derive().validate()
        self.jcfg.ckpt_path = os.path.join(root, "jax")
        self.port = build_model(self.cfg, device="cpu")
        self.port.load_state_dict(sd, strict=True)
        self.steps = evaluate.make_eval_step(self.port, self.cfg)
        self.jsteps = jeval.make_eval_step(jmodel, self.jcfg)
        self.jargs = (jmodel, params, stats)

    def run(self, set_name="test", **kw):
        """(port stat, JAX stat) of one evaluate over ``batches()``."""
        want = jeval.evaluate(*self.jargs, self.jcfg, batches(),
                              phase="test", set_name=set_name,
                              eval_steps=self.jsteps, **kw)
        got = evaluate.evaluate(self.port, self.cfg, batches(),
                                phase="test", set_name=set_name,
                                eval_steps=self.steps, **kw)
        return got, want

    def files(self, name, set_name="test"):
        return [read_h5(os.path.join(c.ckpt_path, "result_" + set_name,
                                     name)) for c in (self.cfg, self.jcfg)]


@pytest.fixture(scope="module")
def pair():
    """(port state_dict, JAX model, params, batch stats): one JAX model."""
    sd = port_weights()
    jcfg = JaxConfig(**dict(BASE, remat=False, use_pallas=False)
                     ).derive().validate()
    return (sd, jax_build_model(jcfg)) + jax_weights(sd)


def batches():
    """Three batches: full, with a padding row, short (one row)."""
    rs = np.random.default_rng(11)
    out = []
    for i, (n, names) in enumerate(((B, ["subj_a", "subj_a"]),
                                    (B, ["subject_bb", "subj_a"]),
                                    (1, ["s_c"]))):
        x = rs.normal(size=(M, n, H, W, CB)).astype(np.float32)
        x[:, :, :6] = 0.0
        mask = np.ones((n, M), np.float32)
        if i == 0:
            x[0, 1] = 0.0
            mask[1, 0] = 0.0
        b = {"inputs": x, "mask": mask,
             "mask_img": (x[0, :, :, :, 0] == 0).astype(np.float32),
             "targets": np.abs(rs.normal(size=(n, H, W, 1))).astype(
                 np.float32),
             "subj_id": names,
             "slice_idx": np.arange(10 * i, 10 * i + n, dtype=np.int64)}
        if i == 1:
            b["valid"] = np.array([True, False])
        out.append(b)
    return out


def read_h5(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


def assert_dumps_match(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), k
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g.dtype == np.float32, k
            np.testing.assert_allclose(g, w, atol=OUT_ATOL, err_msg=k)


def assert_stats_match(got, want):
    assert list(got) == list(want)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)
    for k in list(want)[len(LOSS_KEYS):]:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **METRIC_TOL)


@pytest.fixture(scope="module")
def no_y(pair, tmp_path_factory):
    sides = Sides(pair, str(tmp_path_factory.mktemp("no_y")))
    return sides, sides.run(save_res=True)


def test_dump_matches_jax_with_the_stale_y_rows(no_y):
    """No y-loss: the y of batch 0 is appended at every batch, so with the
    padding row dropped and the short last batch, y has 5 rows where the
    inputs have 4, on both sides."""
    sides, (got, want) = no_y
    assert_stats_match(got, want)
    port, ref = sides.files("results_all.h5")
    assert_dumps_match(port, ref)
    assert port["inputs"].shape == (4, M * CB, H, W)
    assert port["y_fake_fused"].shape[0] == 5
    np.testing.assert_array_equal(port["y_fake_fused"][2],
                                  port["y_fake_fused"][0])
    np.testing.assert_array_equal(port["y_fake_list"][3:],
                                  port["y_fake_list"][:2])
    assert port["subj_id"].dtype == np.dtype("S10")
    assert port["subj_id"].tolist() == [b"subj_a", b"subj_a",
                                        b"subject_bb", b"s_c"]
    assert port["slice_idx"].tolist() == [0, 1, 10, 20]
    assert port["xi_fake_mix"].shape == (4, M * (M - 1), CB, H, W)
    assert port["s_list"].shape[:2] == port["z_list"].shape[:2] == (4, M)


def test_dump_matches_jax_with_a_y_loss(pair, tmp_path):
    """A y-loss on: y decoded at every batch (rows as the inputs), the
    metrics on the fused y."""
    sides = Sides(pair, str(tmp_path), **Y_LOSS)
    got, want = sides.run(save_res=True)
    assert {"ssim", "psnr", "rmse"} <= set(got)
    assert_stats_match(got, want)
    port, ref = sides.files("results_all.h5")
    assert_dumps_match(port, ref)
    assert port["y_fake_fused"].shape == (4, 1, H, W)
    assert port["y_fake_list"].shape == (4, M, 1, H, W)


@pytest.mark.parametrize("info", ["nearest_neighbour", "mean",
                                  "nearest_neighbour_src=0"])
def test_retrieval_matches_jax(no_y, info):
    """Both packages read one bank, JAX's ``results_all.h5`` of the no-y
    run copied into the port's result directory, so that only retrieval
    is compared: ``z_list_find_all``, the re-decoded grid, the metrics
    recomputed from it, and the stat dict."""
    sides, _ = no_y
    bank = os.path.join(sides.jcfg.ckpt_path, "result_test", "results_all.h5")
    shutil.copyfile(bank, os.path.join(sides.cfg.ckpt_path, "result_test",
                                       "results_all.h5"))
    got, want = sides.run(save_res=True, info=info)
    assert_stats_match(got, want)
    port, ref = sides.files("results_all" + info + ".h5")
    assert_dumps_match(port, ref)
    z = read_h5(bank)["z_list"]
    found = port["z_list_find_all"]
    assert found.shape == (4, M, z.shape[-1])
    if info == "mean":
        np.testing.assert_allclose(found, np.broadcast_to(
            z.mean(0), found.shape), rtol=1e-6)
    else:                                   # rows of the bank, as JAX's
        np.testing.assert_array_equal(found, ref["z_list_find_all"])
        for i in range(M):
            assert all((z[:, i] == row).all(-1).any() for row in found[:, i])


def test_retrieval_from_an_in_memory_bank_and_a_writer(no_y):
    """The two seams: ``bank`` in place of the bank file and ``writer`` in
    place of the HDF5 stream give the rows of the file path."""
    sides, _ = no_y
    bank = read_h5(os.path.join(sides.jcfg.ckpt_path, "result_test",
                                "results_all.h5"))
    bank = (bank["s_list"], bank["z_list"])
    rows = {}

    class Recorder:
        def __init__(self, path):
            self.path = path

        def append(self, key, arr):
            rows.setdefault(key, []).append(np.asarray(arr))

        def close(self):
            rows["closed"] = self.path

    kw = dict(phase="test", set_name="seam", save_res=True, info="mean",
              eval_steps=sides.steps, bank=bank)
    want_stat = evaluate.evaluate(sides.port, sides.cfg, batches(), **kw)
    stat = evaluate.evaluate(sides.port, sides.cfg, batches(),
                             writer=Recorder, **kw)
    path = os.path.join(sides.cfg.ckpt_path, "result_seam",
                        "results_allmean.h5")
    assert rows.pop("closed") == path and stat == want_stat
    got = {k: np.concatenate(v) for k, v in rows.items()}
    want = read_h5(path)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_nearest_neighbour_and_mean_z_match_jax():
    """Unit parity with a planted tie: bank rows 1 and 3 are equal and
    nearest to query 0; both packages take the first (row 1)."""
    rs = np.random.default_rng(5)
    s_bank = rs.normal(size=(5, 12)).astype(np.float32)
    s_bank[3] = s_bank[1]
    z_bank = rs.normal(size=(5, 4)).astype(np.float32)
    query = np.stack([s_bank[1] * 2.0, s_bank[4]]).astype(np.float32)
    got = losses.nearest_neighbour_z_by_s(
        torch.from_numpy(s_bank), torch.from_numpy(z_bank),
        torch.from_numpy(query)).numpy()
    want = np.asarray(jlosses.nearest_neighbour_z_by_s(
        jnp.asarray(s_bank), jnp.asarray(z_bank), jnp.asarray(query)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, z_bank[[1, 4]])
    np.testing.assert_allclose(
        losses.mean_z(torch.from_numpy(z_bank)).numpy(),
        np.asarray(jlosses.mean_z(jnp.asarray(z_bank))), rtol=1e-6)


def test_dump_without_h5py_or_a_seam_raises(pair, tmp_path, monkeypatch):
    """No fallback: without h5py the dump needs a writer and the retrieval
    a bank, and nothing is written."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    cfg = Config(**BASE).derive().validate()
    cfg.ckpt_path = str(tmp_path)
    for kw in (dict(phase="test", save_res=True), dict(info="mean"),
               dict(info="nearest_neighbour_src=1",
                    writer=lambda path: None)):
        with pytest.raises(ImportError, match="h5py"):
            evaluate.evaluate(None, cfg, [], **kw)
    assert not list(tmp_path.iterdir())
