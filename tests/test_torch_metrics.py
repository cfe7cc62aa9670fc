"""The port's evaluation metrics (metrics.py, training/evaluate.py::
mix_metric_mat) against the JAX package's, on the same seeded numpy inputs
on the CPU, in f32.

Tolerance: rtol 1e-5 (plus atol 1e-6 for values near 0).  The SSIM window
means are ``avg_pool2d`` here and ``reduce_window`` sums there, so the two
sum each window in another order; measured at most 5.8e-7 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu import metrics as jmetrics
from representation_disentanglement_tpu.training import evaluate as jeval
from representation_disentanglement_torch import metrics
from representation_disentanglement_torch.training import evaluate

TOL = dict(rtol=1e-5, atol=1e-6)


def _slices(b=4, h=32, w=40, seed=0):
    """Target and prediction slices with different minima (negative, as
    z-scored MR is) and a zero background band."""
    rs = np.random.default_rng(seed)
    t = rs.normal(size=(b, h, w)).astype(np.float32) - 0.7
    p = (t + 0.3 * rs.normal(size=(b, h, w))).astype(np.float32)
    t[:, :4] = 0.0
    p[:, :3] = 0.1
    return t, p


def _cmp(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("data_range", [1.0, 3.7])
def test_ssim_single_matches_jax(data_range):
    t, p = _slices(seed=1)
    t, p = t - t.min(), p - p.min()
    _cmp(metrics.ssim_single(torch.from_numpy(t[0]), torch.from_numpy(p[0]),
                             data_range),
         jmetrics.ssim_single(jnp.asarray(t[0]), jnp.asarray(p[0]),
                              data_range))
    batched = metrics.ssim_single(torch.from_numpy(t), torch.from_numpy(p),
                                  torch.full((4,), data_range))
    assert tuple(batched.shape) == (4,)
    _cmp(batched, [jmetrics.ssim_single(jnp.asarray(a), jnp.asarray(b),
                                        data_range) for a, b in zip(t, p)])


def test_recon_metrics_match_jax():
    """The min shift of each slice and data_range = the shifted target's
    maximum, per slice; identical slices give SSIM 1 and PSNR inf."""
    t, p = _slices(seed=2)
    p[3] = t[3]
    got = metrics.recon_metrics_device(torch.from_numpy(t),
                                       torch.from_numpy(p))
    want = jmetrics.recon_metrics_device(jnp.asarray(t), jnp.asarray(p))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (4,)
        _cmp(g[:3], w[:3])
    assert float(got[0][3]) == pytest.approx(1.0)
    assert np.isinf(float(got[1][3])) and np.isinf(float(want[1][3]))
    shifted = metrics.recon_metrics_device(torch.from_numpy(t + 5.0),
                                           torch.from_numpy(p - 2.0))
    for g, s in zip(got, shifted):          # invariant to each slice's min
        _cmp(s[:3], g[:3])


def test_seg_metrics_match_jax_on_a_brats_label_map():
    """Labels 0-3 (background, necrotic core, edema, enhancing tumour) and
    per-class prediction maps; channel i scores class i+1; an empty class
    scores 1 by the +1 smoothing."""
    rs = np.random.default_rng(3)
    yy, xx = np.meshgrid(np.arange(32), np.arange(40), indexing="ij")
    r = np.hypot(yy - 16, xx - 20)
    label = np.where(r < 4, 3, np.where(r < 8, 1, np.where(r < 12, 2, 0)))
    target = np.stack([label, np.roll(label, 3, 1), label * (label != 3),
                       np.zeros_like(label)]).astype(np.float32)
    pred = rs.uniform(size=(4, 32, 40, 4)).astype(np.float32)
    pred[..., :3] = np.clip(pred[..., :3] * 0.6 + 0.5 * np.stack(
        [target == c for c in (1, 2, 3)], -1), 0, 1)
    pred[3] = 0.0
    got = metrics.seg_metrics_device(torch.from_numpy(target),
                                     torch.from_numpy(pred))
    want = jmetrics.seg_metrics_device(jnp.asarray(target), jnp.asarray(pred))
    for g, w in zip(got, want):
        _cmp(g, w)
    assert float(got[0][3]) == float(got[1][3]) == 1.0
    host = metrics.compute_segmentation_metrics(target[..., None], pred)
    jhost = jmetrics.compute_segmentation_metrics(target[..., None], pred)
    assert host == jhost
    _cmp(host["dice"], got[0])


def test_mix_metric_mat_matches_jax():
    """[3, M(M-1)*B] in the reference's i-major, j != i order."""
    rs = np.random.default_rng(4)
    m, b = 3, 2
    inputs = rs.normal(size=(m, b, 24, 32, 2)).astype(np.float32)
    grid = (inputs[None] + 0.2 * rs.normal(size=(m, m, b, 24, 32, 2))
            ).astype(np.float32)
    got = evaluate.mix_metric_mat(torch.from_numpy(inputs),
                                  torch.from_numpy(grid))
    want = jeval.mix_metric_mat(jnp.asarray(inputs), jnp.asarray(grid))
    assert tuple(got.shape) == want.shape == (3, m * (m - 1) * b)
    _cmp(got, want)


def test_host_reconstruction_metrics_match_jax():
    t, p = _slices(seed=5)
    got = metrics.compute_reconstruction_metrics(t[..., None], p[..., None],
                                                 device="cpu")
    want = jmetrics.compute_reconstruction_metrics(t[..., None], p[..., None])
    assert list(got) == list(want) == ["ssim", "psnr", "rmse"]
    for k in want:
        _cmp(got[k], want[k])


def test_host_reconstruction_metrics_refuse_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, p = _slices(b=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.compute_reconstruction_metrics(t[..., None], p[..., None])
