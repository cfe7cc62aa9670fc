"""The metric arithmetic on a small synthetic trace: the idle union, the
exposed collective time, the idle gaps' host labels, the roofline's bytes,
the per-step kernel time and the mfu."""

import pytest

from benchmark import counts, readers
from benchmark.trace import Op, Trace, exposed, gaps, union

PEAK = counts.peaks("NVIDIA H100 80GB HBM3")


def _trace():
    # window 0-10 s; kernels 1-3, 2-4 (overlapping) and 6-7: busy 4 s
    kernels = [("conv_a", 1.0, 3.0), ("conv_b", 2.0, 4.0),
               ("void_cudnn::nchwToNhwcKernel", 6.0, 7.0)]
    ops = [Op("aten::add_", 3.5, 6.5, 1, [], 0.0),
           Op("Optimizer.step", 3.0, 9.0, 1, [], 0.0),
           Op("rdt::in_modulate", 1.0, 2.0, 1, [[2, 4, 8, 8], [2, 4, 8, 8],
                                                [2, 4, 8, 8]], 2.0),
           Op("rdt::in_modulate_bwd", 2.0, 3.0, 1, [[2, 4, 8, 8]] * 3, 1.0),
           Op("other_thread", 0.0, 10.0, 2, [], 0.0)]
    return Trace((0.0, 10.0), kernels, ops, 2, {"thread": 1})


def test_union_and_gaps():
    assert union([(2, 4), (1, 3), (6, 7)]) == [(1, 4), (6, 7)]
    assert gaps([(1, 4), (6, 7)], 0, 10) == [(0, 1), (4, 6), (7, 10)]


def test_idle_share_is_the_window_less_the_union():
    ctx = {"trace": _trace()}
    assert _trace().busy_s() == pytest.approx(4.0)
    assert readers.device_idle_pct(ctx) == pytest.approx(60.0)


def test_exposed_collective_time():
    nccl = [(0.5, 1.5), (3.5, 6.5)]
    compute = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0)]
    # 0.5-1.0 and 4.0-6.0 have no compute under them
    assert exposed(nccl, compute) == pytest.approx(2.5)


def test_idle_gaps_name_the_innermost_host_op():
    g = _trace().idle_gaps()
    # gaps 7-10 (3 s), 4-6 (2 s), 0-1 (1 s); at 4.0 aten::add_ (started
    # 3.5) is inside Optimizer.step (started 3.0); at 7.0 only the step
    assert [n for n, _ in g] == ["host_in_Optimizer.step",
                                 "host_in_aten::add_",
                                 "host_in_outside_any_op"]
    assert [d for _, d in g] == pytest.approx([3.0, 2.0, 1.0])


def test_in_modulate_bytes_by_hand():
    # zi [2, 4, 8, 8] bf16: forward reads zi, gamma, beta and writes the
    # result, 4 * 512 * 2 B; backward reads 3 and writes 2, 5 * 512 * 2 B
    assert counts.in_modulate_cost("rdt::in_modulate", [2, 4, 8, 8],
                                   "bfloat16") == (4096, 4096.0)
    assert counts.in_modulate_cost("rdt::in_modulate_bwd", [2, 4, 8, 8],
                                   "bfloat16") == (5120, 6144.0)


def test_roofline_share_by_hand():
    ctx = {"trace_shapes": _trace(), "peak": PEAK,
           "config": {"compute_dtype": "bfloat16"}}
    least = (4096 + 5120) / 3.35e12          # both bound by the bytes
    assert readers.roofline_pct(ctx, ("rdt::in_modulate",
                                      "rdt::in_modulate_bwd")) == \
        pytest.approx(100 * least / 3.0)
    assert readers.roofline_pct(ctx, ("rdt::in_modulate",)) == \
        pytest.approx(100 * 4096 / 3.35e12 / 2.0)
    assert readers.roofline_pct({**ctx, "trace_shapes": None},
                                ("rdt::in_modulate",)) is None


def test_layout_ms_per_step():
    ctx = {"trace": _trace()}
    assert readers.kernel_ms_per_unit(
        ctx, ("nchwToNhwc", "nhwcToNchw")) == pytest.approx(500.0)


def test_mfu_by_hand():
    ctx = {"result": {"flop_per_unit": 2.0e13, "unit_s": 0.2},
           "peak": PEAK, "config": {"compute_dtype": "bfloat16"}}
    assert readers.mfu_pct(ctx) == pytest.approx(100 * 1.0e14 / 989.4e12)
    assert readers.mfu_pct({**ctx, "peak": None}) is None


def test_peak_table_is_the_data_sheet():
    assert PEAK == {"bfloat16": 989.4e12, "float32": 66.9e12,
                    "hbm": 3.35e12}
    assert counts.peaks("NVIDIA A100-SXM4-80GB") is None
