"""The 3D training cell (``volume3d-train-b1``) on the CPU: the cell end to
end, shrunk through ``run_cell(adjust=...)`` to 32x48x32 crops of a fold
of 9 subjects at 8 filters, with its comparison and its planted fault;
``counts3d``'s FLOP against the port's own count; and the readers of the
cell's per-layer metrics, its own three and the four it shares with the
2D training cells, on a synthetic trace."""

from __future__ import annotations

import contextlib
from unittest import mock

import pytest
import torch

from benchmark import counts3d, run
from benchmark.tests.bench_tiny import SEED, few_threads  # noqa: F401
from benchmark.trace import Op, Trace

CELL = "volume3d-train-b1"
OWN = ("mfu.train3d", "wgrad_ms_per_step.train3d",
       "group_norm_ms_per_step.train3d")
SHARED = ("device_idle.train", "driver_idle_ms_per_step.train",
          "step_idle_ms_per_step.train", "layout_ms_per_step.train")
METRICS = OWN + SHARED


def shrink(rc: dict, traffic: dict) -> None:
    rc.update(init_channels=8, squeeze_channels=32, image_size=[32, 48, 32],
              input_height=32, input_width=48, slab_start=4)
    rc["data"] = dict(rc["data"], cohort=12, depth=40)


@contextlib.contextmanager
def tiny_driver():
    from benchmark import drive_train3d
    with mock.patch.multiple(drive_train3d, WARM_STEPS=1, TRACED_STEPS=1):
        yield


def run_tiny(trace=False, adjust=shrink):
    with tiny_driver():
        return run.run_cell(CELL, SEED, 0.01, trace, "cpu", adjust)


def test_the_cell_matches_the_reference(few_threads):
    """float32 on both sides, the same crops and draws: the first step's
    terms and the median leaf's first gradient agree to float32 rounding
    (measured 0 and 2e-8 here)."""
    out = run_tiny(trace=True)
    r = out["readings"]
    assert out["correct"], out["checks"]
    assert r["terms_step1_max"] < 1e-5 and r["grad_gap_median"] < 1e-5
    assert {"tf32_cudnn", "tf32_matmul"} <= set(r)
    assert out["failed"] == 0 and out["attempted"] >= 1
    # the CPU knows no TF32 peak: the mfu reads nothing, the others read
    assert set(out["metrics"]) == set(METRICS) - {"mfu.train3d"}
    assert out["metrics"]["driver_idle_ms_per_step.train"]["value"] > 0


def test_a_state_left_unchanged_is_not_correct(few_threads, monkeypatch):
    from representation_disentanglement_torch.training import train3d
    create = train3d.create_state_3d

    def frozen(model, **kw):
        opt = create(model, **kw)
        opt.step = lambda *a, **k: None
        return opt
    monkeypatch.setattr(train3d, "create_state_3d", frozen)
    out = run_tiny()
    assert not out["correct"]
    assert out["readings"]["change_gap_median"] > 0.9   # 1 on most leaves


def test_step_flop_is_three_port_forwards():
    from representation_disentanglement_torch.bench3d import forward_flop
    from representation_disentanglement_torch.models.unet3d import (
        build_nvnet3d)
    cfg = {"init_channels": 8, "squeeze_channels": 32,
           "contrast_list": ["T1", "T1c", "T2", "T2_FLAIR"],
           "image_size": [32, 48, 32]}
    model = build_nvnet3d((32, 48, 32), 4, 3, 8, device="cpu",
                          squeeze_channels=32)
    port = forward_flop(model, torch.zeros(2, 4, 32, 48, 32))
    assert counts3d.forward_flop(cfg, 2) == port
    assert counts3d.train_step_flop(cfg, 2, 3) == 9 * port


def _trace():
    # window 0-10 s, 2 steps; kernels 1-3, 2-4, 6-7 and 8-8.5: busy 4.5 s
    kernels = [("sm90_xmma_wgrad_implicit_gemm_tf32", 1.0, 3.0),
               ("cudnn::wgrad2d_grouped_direct_kernel", 2.0, 4.0),
               ("GroupNormKernel", 6.0, 7.0),
               ("nchwToNhwcKernel", 8.0, 8.5)]
    ops = [Op("rdt.train.step", 0.5, 4.5, 1, [], 0.0),
           Op("rdt.train.step", 5.5, 9.5, 1, [], 0.0),
           Op("rdt.load3d", 4.6, 5.4, 1, [], 0.0),
           Op("aten::group_norm", 5.9, 7.1, 1, [], 1.0),
           Op("aten::native_group_norm", 6.0, 7.0, 1, [], 1.0),
           Op("aten::native_group_norm_backward", 6.5, 7.5, 2, [], 0.5)]
    return Trace((0.0, 10.0), kernels, ops, 2, {"thread": 1})


def test_the_cells_readers_on_a_synthetic_trace():
    res = {"flop_per_unit": 9.2e12, "unit_s": 0.7,
           "card": "NVIDIA H100 80GB HBM3"}
    ctx = {"trace": _trace(), "trace_shapes": None, "result": res,
           "config": {}, "peak": None}
    got = {m: run.reader(m)(ctx) for m in METRICS}
    assert got["mfu.train3d"] == pytest.approx(
        100 * 9.2e12 / 0.7 / 494.7e12)
    assert 0 < got["mfu.train3d"] <= 100
    assert got["device_idle.train"] == pytest.approx(55.0)
    # idle outside the step spans: 0-0.5, 4.5-5.5, 9.5-10 (2 s), 2 steps
    assert got["driver_idle_ms_per_step.train"] == pytest.approx(1000.0)
    # idle inside them: 0.5-1, 4-4.5, 5.5-6, 7-8, 8.5-9.5 (3.5 s)
    assert got["step_idle_ms_per_step.train"] == pytest.approx(1750.0)
    assert got["layout_ms_per_step.train"] == pytest.approx(250.0)
    # both wgrad kernels, 2 + 2 s over 2 steps
    assert got["wgrad_ms_per_step.train3d"] == pytest.approx(2000.0)
    # native forward and backward (the enclosing aten::group_norm is not
    # counted twice), 1.5 s over 2 steps
    assert got["group_norm_ms_per_step.train3d"] == pytest.approx(750.0)


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_reads_none(name):
    ctx = {"trace": None, "trace_shapes": None, "result": {},
           "config": {}, "peak": None}
    assert run.reader(name)(ctx) is None
