"""The port's validation step and loop (training/evaluate.py) against the
JAX package's ``make_eval_step`` and ``evaluate``, on the CPU.

The eval step runs on the model and weights of tests/test_torch_train_model
(``Pair``: the flagship structure at M=2, 32x64, B=2, f32, non-default
running statistics).  The loop is held against JAX's with the same stand-in
eval step on both sides, so that the comparison isolates what the loop
itself does: the sim and adversarial pairs drawn from ``sim_rng``, the y
decodes at the first batch only, the ``valid`` rows, the
``eval_max_iters`` stop and the averages.

Tolerances, with what was measured on a CPU: the loss vector rtol 1e-4 /
atol 1e-7 (tests/test_torch_train_model.py's; measured 1.3e-4 relative on
latent_z, 2e-8 absolute and within the atol, 1.3e-7 on the others); the
metric matrix rtol 1e-4 / atol 1e-6 (measured 5.7e-6 absolute, 1e-6
relative, on the PSNRs).  The slice whose contrast is absent has an empty
ground truth: SSIM 0 and PSNR -inf on both sides, by the reference's rule.
"""

import sys

import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.config import Config as JaxConfig
from representation_disentanglement_tpu.training import evaluate as jeval
from representation_disentanglement_torch import config
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.training import evaluate
from representation_disentanglement_torch.training.train import LOSS_KEYS
from test_torch_train_model import CFG, Pair, SIM_PAIR, _batch

LOSS_TOL = dict(rtol=1e-4, atol=1e-7)
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_eval_config_fields_match_jax():
    ours, ref = config.Config().derive(), JaxConfig().derive()
    for name in ("eval_max_iters", "fuse_bn", "dataset_name"):
        assert getattr(ours, name) == getattr(ref, name), name


@pytest.mark.parametrize("compute_y", [True, False])
def test_eval_step_matches_jax(pair, compute_y):
    """The loss vector, the [3, M(M-1)*B] metric matrix and the outputs of
    one eval step; the y decodes run only with ``compute_y``; and
    ``decode_with_z`` on the step's anatomy codes with other z."""
    batch = _batch(pair.m)
    jstep, jdecode, jnames = jeval.make_eval_step(pair.jmodel, pair.jcfg)
    jout, jloss, jmat = jstep(pair.v["params"], pair.v["batch_stats"],
                              batch, SIM_PAIR, SIM_PAIR, compute_y=compute_y)
    port = pair.port()
    step, decode, names = evaluate.make_eval_step(port, pair.cfg)
    out, loss, mat = step(batch, SIM_PAIR, SIM_PAIR, compute_y=compute_y)
    assert names == jnames == ("ssim", "psnr", "rmse")
    assert not port.training
    assert ("y_fake_fused" in out) == ("y_fake_fused" in jout) == compute_y
    assert loss.dtype == torch.float32 and tuple(loss.shape) == (11,)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **LOSS_TOL)
    assert tuple(mat.shape) == jmat.shape == (3, 2 * pair.m * (pair.m - 1))
    np.testing.assert_allclose(mat.numpy(), np.asarray(jmat), **METRIC_TOL)
    np.testing.assert_allclose(out["x_fake_grid"].numpy(),
                               np.asarray(jout["x_fake_grid"]), atol=2e-4)
    if compute_y:                       # the re-decode from given s and z
        z = np.asarray(jout["z"])[::-1].copy()
        want = jdecode(pair.v["params"], pair.v["batch_stats"], jout["s"], z)
        got = decode(torch.from_numpy(np.asarray(jout["s"])),
                     torch.from_numpy(z))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_bf16_eval_step_scores_the_uncast_inputs(pair):
    """Under bf16 the model sees bf16 inputs, while the metrics score the
    f32 inputs (JAX evaluate.py:87-92)."""
    cfg = config.Config(**CFG, compute_dtype="bfloat16").derive().validate()
    port = build_model(cfg, device="cpu")
    port.load_state_dict(pair.sd, strict=True)
    batch = _batch(pair.m)
    step, _, _ = evaluate.make_eval_step(port, cfg)
    out, loss, mat = step(batch, SIM_PAIR, compute_y=False)
    grid = out["x_fake_grid"]
    assert grid.dtype == torch.bfloat16 and loss.dtype == torch.float32
    f32 = evaluate.mix_metric_mat(torch.from_numpy(batch["inputs"]), grid)
    cast = evaluate.mix_metric_mat(
        torch.from_numpy(batch["inputs"]).bfloat16(), grid)
    assert torch.equal(mat, f32)
    assert not torch.equal(mat, cast)


def _loader(n, m, b, h=16, w=16, seed=0, consumed=None):
    """n batches of the in-memory loader contract; batch 1 has a padding
    row (``valid`` False).  Appends each index to ``consumed``."""
    rs = np.random.default_rng(seed)
    for i in range(n):
        if consumed is not None:
            consumed.append(i)
        batch = {"inputs": rs.normal(size=(m, b, h, w, 1)).astype(np.float32),
                 "targets": np.zeros((b, h, w, 1), np.float32),
                 "mask": np.ones((b, m), np.float32),
                 "mask_img": np.zeros((b, h, w), np.float32)}
        if i == 1:
            batch["valid"] = np.array([True, False, True])
        yield batch


def _stand_in(record, names, jax_signature):
    """An eval step whose losses and metrics follow from the batch: it
    records (sim pair, adversarial pair, compute_y) per call."""
    def step(batch, sim_pair, adv_pair, compute_y):
        record.append((np.asarray(sim_pair).tolist(),
                       np.asarray(adv_pair).tolist(), compute_y))
        x = np.asarray(batch["inputs"], np.float64)
        m, b = x.shape[:2]
        loss = np.arange(len(LOSS_KEYS)) * float(x.mean()) + compute_y
        per = np.abs(x).mean(axis=(2, 3, 4))                # [M, B]
        mat = np.stack([np.tile(per.mean(0), m * (m - 1)) * (k + 1)
                        for k in range(len(names))])
        return {}, loss.astype(np.float32), mat.astype(np.float32)

    if jax_signature:
        return lambda params, stats, batch, sim, adv, compute_y: step(
            batch, sim, adv, compute_y)
    return lambda batch, sim, adv=None, compute_y=True: step(
        batch, sim, adv, compute_y)


def test_evaluate_loop_matches_jax(tmp_path):
    """M=4: per batch a sim pair and an adversarial pair from the same
    stream (sim pairs drift from the second batch on if one draw is left
    out), compute_y at the first batch only, the padding row's metrics
    dropped, and the stop after batch ``eval_max_iters`` (here 2: three
    batches of five are read)."""
    names = ("ssim", "psnr", "rmse")
    m, b = 4, 3
    jcfg = JaxConfig(eval_max_iters=2, ckpt_path=str(tmp_path)).derive()
    cfg = config.Config(eval_max_iters=2).derive()
    assert cfg.modality_num == jcfg.modality_num == m
    jrec, rec, consumed = [], [], []
    want = jeval.evaluate(None, None, None, jcfg, _loader(5, m, b),
                          eval_steps=(_stand_in(jrec, names, True), None,
                                      names))
    got = evaluate.evaluate(None, cfg, _loader(5, m, b, consumed=consumed),
                            eval_steps=(_stand_in(rec, names, False), None,
                                        names))
    assert rec == jrec and len(rec) == 3 and consumed == [0, 1, 2]
    assert [r[2] for r in rec] == [True, False, False]
    assert len({tuple(r[0]) for r in rec}) > 1          # the stream moves
    assert list(got) == list(want) == list(LOSS_KEYS) + list(names)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-12)


def test_evaluate_refuses_the_dump_and_retrieval(tmp_path, monkeypatch):
    """Without h5py and without a writer or bank, the dump and the
    retrieval raise ImportError, as JAX's (evaluate.py:197-199), and
    nothing is written; tests/test_torch_dump.py holds both against JAX."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    cfg = config.Config().derive()
    for kw in (dict(save_res=True), dict(info="nearest_neighbour"),
               dict(info="mean_src=1")):
        with pytest.raises(ImportError, match="h5py"):
            evaluate.evaluate(None, cfg, [], **kw)
    assert not list(tmp_path.iterdir())
    assert evaluate.parse_retrieval_info("mean_src=2") == \
        jeval.parse_retrieval_info("mean_src=2") == ("mean", 2)
    assert evaluate.parse_retrieval_info("val") == (None, None)
