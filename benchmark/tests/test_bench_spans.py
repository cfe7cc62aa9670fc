"""The idle split by the program's spans (``spans.py`` and its six metric
readers) on a small synthetic trace, worked by hand."""

import pytest

from benchmark import readers, run
from benchmark.spans import intersect
from benchmark.trace import Op, Trace

TRAIN = ("driver_idle_ms_per_step.train", "step_idle_ms_per_step.train",
         "resize_idle_ms_per_step.train")
IMPUTE = ("serve_idle_ms_per_request.impute",
          "resize_idle_ms_per_request.impute")


def _trace(step="rdt.train.step", units=2):
    # window 0-20 s; busy 1-3, 5-6, 8-9, 12-13, 15-16: idle 0-1, 3-5,
    # 6-8, 9-12, 13-15, 16-20 (14 s)
    kernels = [("k", 1.0, 3.0), ("k", 5.0, 6.0), ("k", 8.0, 9.0),
               ("k", 12.0, 13.0), ("k", 15.0, 16.0)]
    ops = [Op(step, 2.0, 10.0, 1, [], 0.0),
           Op(step, 11.0, 17.0, 1, [], 0.0),
           Op("rdt.resize", 4.0, 7.0, 1, [], 0.0),
           Op("rdt.resize", 14.0, 14.5, 1, [], 0.0),
           Op("rdt.resize.upload", 4.0, 4.5, 1, [], 0.0),
           Op("rdt.resize.upload", 4.5, 5.0, 1, [], 0.0),
           Op("rdt.resize.upload", 14.0, 14.2, 1, [], 0.0),
           Op("rdt.resize.upload", 21.0, 21.5, 1, [], 0.0),  # after it
           Op("aten::add_", 2.5, 9.5, 1, [], 0.0),
           # another thread: ignored, though it overlaps idle time
           Op("rdt.resize", 0.0, 1.0, 2, [], 0.0),
           Op("rdt.resize.upload", 0.0, 0.5, 2, [], 0.0),
           Op(step, 18.0, 20.0, 2, [], 0.0)]
    return Trace((0.0, 20.0), kernels, ops, units, {"thread": 1})


def _read(name, tr):
    return run.reader(name)({"trace": tr})


def test_intersect():
    assert intersect([(0, 2), (3, 5), (6, 9)], [(1, 4), (8, 10)]) == \
        [(1, 2), (3, 4), (8, 9)]
    assert intersect([(0, 1)], []) == []


def test_training_idle_by_hand():
    tr = _trace()
    # S(step) 2-10, 11-17.  Idle outside it: 0-1, 10-11, 17-20 (5 s);
    # inside: 3-5, 6-8, 9-10, 11-12, 13-15, 16-17 (9 s), of which inside
    # S(resize) 4-7, 14-14.5: 4-5, 6-7, 14-14.5 (2.5 s)
    got = [_read(n, tr) for n in TRAIN]
    assert got == pytest.approx([2500.0, 3250.0, 1250.0])
    # 3 uploads on the stepping thread inside the stretch, 2 steps
    assert _read("resize_uploads_per_step.train", tr) == pytest.approx(1.5)


def test_training_parts_sum_to_the_idle_share():
    tr = _trace()
    idle_pct = readers.device_idle_pct({"trace": tr})
    assert idle_pct == pytest.approx(70.0)
    assert sum(_read(n, tr) for n in TRAIN) == \
        pytest.approx(1e3 * idle_pct * tr.window_s / 100 / tr.units)


def test_imputation_idle_by_hand():
    tr = _trace("rdt.serve.step", units=4)
    assert [_read(n, tr) for n in IMPUTE] == pytest.approx([1625.0, 625.0])
    # with the 5 s outside the serve step, the device_idle share
    assert (sum(_read(n, tr) for n in IMPUTE) * tr.units / 1e3 + 5.0) == \
        pytest.approx(readers.device_idle_pct({"trace": tr})
                      * tr.window_s / 100)


def test_other_threads_are_ignored():
    tr = _trace()
    # spans of thread 2 alone, and the stepping thread's moved to 3: the
    # first step span is thread 3's, so thread 2's resizes do not count
    moved = Trace(tr.window, tr.kernels,
                  [Op(o.name, o.start, o.end, 3 if o.thread == 1 else 2,
                      o.shapes, o.device_s) for o in tr.ops], tr.units, {})
    assert [_read(n, moved) for n in TRAIN] == \
        pytest.approx([2500.0, 3250.0, 1250.0])
    alone = Trace(tr.window, tr.kernels,
                  [o for o in tr.ops if o.thread == 2], tr.units, {})
    # thread 2's step 18-20 holds idle 18-20; its resize 0-1 is outside
    assert [_read(n, alone) for n in TRAIN] == \
        pytest.approx([6000.0, 1000.0, 0.0])


@pytest.mark.parametrize("name", TRAIN + IMPUTE
                         + ("resize_uploads_per_step.train",))
def test_no_step_span_reads_none(name):
    tr = _trace("some.other.span")
    assert _read(name, tr) is None
    assert _read(name, None) is None
