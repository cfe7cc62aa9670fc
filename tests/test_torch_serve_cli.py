"""The port's serving CLI (``serve.serve`` and ``serve.main``) against the
JAX package's ``serve``, on the CPU, over the test fold of
tests/test_torch_test_phase.py's data and checkpoints (two subjects of 5
and 2 slices at B=2, so that a subject's tail batch is padded): the written
``.npy`` volumes of the synthesized and source contrasts and of the fused
y, plain and with a z bank in ``mean`` mode and in ``nearest_neighbour``
mode (the CLI's default), the latter's bank the port's own
``results_all.h5`` of ``--set train``.

Tolerance: the volumes atol 2e-4 (tests/test_torch_dump.py's for model
outputs; measured at most 4.0e-6); the file names equal.  The refusals,
before any file is written: ``--aot-platforms`` (no meaning for the
port), ``--aot`` with a JAX package artifact (``RDTAOT1``, StableHLO),
``--export-aot`` with ``--z-bank``, and ``--format nifti`` without
``nibabel`` (``ImportError``).  tests/test_torch_aot.py runs
``--export-aot`` and ``--aot``.
"""

import os
import sys

import numpy as np
import pytest

from representation_disentanglement_tpu import serve as jserve
from representation_disentanglement_tpu.config import (
    resolve_run as jax_resolve_run)
from representation_disentanglement_torch import main_missing, serve
from representation_disentanglement_torch.config import resolve_run
from test_torch_dump import few_threads, port_weights  # noqa: F401
from test_torch_test_phase import (
    FOLDS, H, LABEL, W, jax_cfg, make_data, make_runs, port_cfg, run_dir)

h5py = pytest.importorskip("h5py")

OUT_ATOL = 2e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    data_dir = make_data(str(tmp_path_factory.mktemp("data")))
    roots = make_runs(str(tmp_path_factory.mktemp("ckpt")), port_weights())
    return data_dir, roots


@pytest.fixture(scope="module")
def plain(setup, tmp_path_factory):
    """The port's volumes without a bank: {subject: paths}."""
    data_dir, roots = setup
    return serve.serve(
        resolve_run(port_cfg(data_dir), roots["port"]).derive().validate(),
        ["T1"], None, str(tmp_path_factory.mktemp("plain")), fmt="npy",
        device="cpu")


def assert_bank_moves_only_the_synthesized(got, plain):
    """The missing T1 takes the bank's z, so its volume moves; the present
    T2 keeps its encoder z, so its reconstruction does not."""
    subj = FOLDS["test"][0][0]
    assert not np.allclose(np.load(got[subj][0]), np.load(plain[subj][0]))
    np.testing.assert_array_equal(np.load(got[subj][1]),
                                  np.load(plain[subj][1]))


def serve_both(setup, out, **kw):
    """Both packages' ``serve`` with ``missing=["T1"]``; returns their
    {subject: paths}."""
    data_dir, roots = setup
    jcfg = jax_resolve_run(jax_cfg(data_dir), roots["jax"]).derive() \
        .validate()
    cfg = resolve_run(port_cfg(data_dir), roots["port"]).derive().validate()
    want = jserve.serve(jcfg, ["T1"], None, os.path.join(out, "jax"),
                        fmt="npy", **kw)
    got = serve.serve(cfg, ["T1"], None, os.path.join(out, "port"),
                      fmt="npy", device="cpu", **kw)
    return got, want


def assert_volumes_match(got, want):
    assert list(got) == list(want) == [s for s, _ in FOLDS["test"]]
    for subj, paths in want.items():
        assert [os.path.basename(p) for p in got[subj]] == \
            [os.path.basename(p) for p in paths]
        for g, w in zip(got[subj], paths):
            a, b = np.load(g), np.load(w)
            n = len(dict(FOLDS["test"])[subj])
            assert a.shape == b.shape == (n, H, W), g
            np.testing.assert_allclose(a, b, atol=OUT_ATOL, err_msg=g)


def test_serve_matches_jax(setup, tmp_path):
    got, want = serve_both(setup, str(tmp_path))
    assert_volumes_match(got, want)
    names = [os.path.basename(p) for p in got[FOLDS["test"][0][0]]]
    assert [n.split("_", 3)[-1] for n in names] == \
        ["T1_synth.npy", "T2_recon.npy", "y.npy"]


def test_serve_with_a_mean_z_bank_matches_jax(setup, plain, tmp_path):
    """``--z-bank <results_all.h5> --z-mode mean``: the missing T1 takes
    the bank's mean z, and its volume differs from the plain one."""
    rs = np.random.default_rng(3)
    bank = str(tmp_path / "bank.h5")
    with h5py.File(bank, "w") as f:
        f["s_list"] = rs.uniform(size=(6, 2, 4, H, W)).astype(np.float32)
        f["z_list"] = rs.normal(size=(6, 2, 16)).astype(np.float32)
    got, want = serve_both(setup, str(tmp_path), z_bank=bank,
                           z_mode="mean")
    assert_volumes_match(got, want)
    assert_bank_moves_only_the_synthesized(got, plain)


def test_serve_with_a_nearest_neighbour_z_bank_matches_jax(setup, plain,
                                                           tmp_path):
    """``--z-bank <results_all.h5>`` in the default ``nearest_neighbour``
    mode, the bank the port's dump of ``--set train`` (8 rows): each
    missing T1 takes the z of the bank row whose compact T2 anatomy is
    nearest the served slice's."""
    data_dir, roots = setup
    main_missing.run(port_cfg(data_dir), ckpt_root=roots["port"],
                     device="cpu", eval_set="train")
    bank = os.path.join(run_dir(roots["port"]), "result_train",
                        "results_all.h5")
    with h5py.File(bank, "r") as f:
        assert f["s_list"].shape == (8, 2, 4, H, W)
    got, want = serve_both(setup, str(tmp_path), z_bank=bank)
    assert_volumes_match(got, want)
    assert_bank_moves_only_the_synthesized(got, plain)


def test_cli_refuses_aot_and_nifti_without_nibabel(setup, tmp_path,
                                                   monkeypatch):
    data_dir, roots = setup
    yaml_path = tmp_path / "config.yaml"
    yaml_path.write_text(
        f"ckpt_timelabel: '{LABEL}'\ncontrast_list: ['T1', 'T2']\n"
        f"data_path: '{data_dir}'\ninput_height: {H}\ninput_width: {W}\n"
        "batch_size: 2\neffective_batch: 2\nis_cond: False\n"
        "others: {'mod_enc_s': False, 'ana_dec_act': 'softmax', "
        "'old': False, 'softmax_remove_mask': True}\n")
    out = tmp_path / "out"
    args = [str(yaml_path), "--ckpt-root", roots["port"], "--missing", "T1",
            "--out-dir", str(out)]
    jax_blob = tmp_path / "jax.rdx"
    jax_blob.write_bytes(b"RDTAOT1\n" + bytes(16))
    for extra, match in (
            (["--export-aot", str(tmp_path / "a.bin"),
              "--aot-platforms", "tpu,cpu"], "aot-platforms"),
            (["--aot", str(jax_blob)], "RDTAOT1"),
            (["--export-aot", str(tmp_path / "a.bin"), "--z-bank",
              str(tmp_path / "bank.h5")], "z-bank")):
        with pytest.raises(ValueError, match=match):
            serve.main(args + extra, device="cpu")
    assert not (tmp_path / "a.bin").exists()
    monkeypatch.setitem(sys.modules, "nibabel", None)
    with pytest.raises(ImportError, match="nibabel"):
        serve.main(args + ["--format", "nifti"], device="cpu")
    assert not out.exists()
    serve.main(args + ["--subjects", FOLDS["test"][1][0], "--no-y"],
               device="cpu")
    assert sorted(os.listdir(out)) == [
        f"{FOLDS['test'][1][0]}_T1_synth.npy",
        f"{FOLDS['test'][1][0]}_T2_recon.npy"]
