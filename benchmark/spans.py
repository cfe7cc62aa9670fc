"""The card's idle time of a traced stretch split by what the program's
host thread was doing, read from the program's own spans (``rdt.*``,
``representation_disentanglement_torch/utils/profiling.span``), which the
profile records on the kernels' clock.

The idle intervals I are those ``readers.device_idle_pct`` measures: the
stretch less the union of the device intervals.  T is the thread that
opened the step span (``rdt.train.step`` or ``rdt.serve.step``); S(name)
is the union of that span's intervals on T, clipped to the stretch.  The
idle time splits into three parts that sum to the whole:

- ``driver``: I outside S(step): the run driver's planning, gather and
  stacking, or the serving client's gather and wait;
- ``step``: I inside S(step) and outside S(``rdt.resize``);
- ``resize``: I inside S(step) and S(``rdt.resize``).

Each reader returns None where the trace holds no step span: a program
without the spans reads nothing, not all of its idle time in the driver.
"""

from __future__ import annotations

from typing import List, Optional

from benchmark.trace import Interval, clip, gaps, total, union

RESIZE = "rdt.resize"


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two disjoint, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def step_thread(tr, step: str) -> Optional[int]:
    """The thread that opened the first ``step`` span, or None."""
    first = min((o for o in tr.ops if o.name == step),
                key=lambda o: o.start, default=None)
    return None if first is None else first.thread


def span_union(tr, name: str, thread: int) -> List[Interval]:
    """S(name): the union of ``name``'s intervals on ``thread``, clipped
    to the stretch."""
    return union(clip([(o.start, o.end) for o in tr.ops
                       if o.name == name and o.thread == thread],
                      *tr.window))


def idle_split(tr, step: str) -> Optional[dict]:
    """{driver, step, resize}: the idle seconds of each part, or None."""
    if tr is None:
        return None
    thread = step_thread(tr, step)
    if thread is None:
        return None
    idle = gaps(union(tr.device_intervals()), *tr.window)
    inside = span_union(tr, step, thread)
    in_step = intersect(idle, inside)
    in_resize = intersect(in_step, span_union(tr, RESIZE, thread))
    return {"driver": total(intersect(idle, gaps(inside, *tr.window))),
            "step": total(in_step) - total(in_resize),
            "resize": total(in_resize)}


def idle_ms_per_unit(ctx, step: str, part: str) -> Optional[float]:
    """Idle milliseconds of ``part`` per traced step or request."""
    tr = ctx["trace"]
    split = idle_split(tr, step)
    if split is None or tr.units <= 0:
        return None
    return 1e3 * split[part] / tr.units


def spans_per_unit(ctx, step: str, name: str) -> Optional[float]:
    """``name`` spans that start in the stretch on the step's thread, per
    traced step or request."""
    tr = ctx["trace"]
    thread = None if tr is None else step_thread(tr, step)
    if thread is None or tr.units <= 0:
        return None
    lo, hi = tr.window
    return sum(1 for o in tr.ops if o.name == name and o.thread == thread
               and lo <= o.start < hi) / tr.units
