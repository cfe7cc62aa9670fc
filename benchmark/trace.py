"""The traced stretch of a ``--trace 1`` run and the reduction of its
device trace: device intervals, busy time, idle gaps and what the host
was doing in each, device time by kernel name, and each op's shapes and
the device time of the kernels it launched.

The arithmetic (``union``, ``clip``, ``gaps``, ``exposed``) works on plain
lists of (start, end) so that tests can hand it a synthetic trace.
"""

from __future__ import annotations

import bisect
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

Interval = Tuple[float, float]


def union(intervals: List[Interval]) -> List[Interval]:
    """Merge intervals into disjoint, sorted ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def total(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def gaps(merged: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that ``merged`` (disjoint, sorted) leaves
    uncovered."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def exposed(part: List[Interval], others: List[Interval]) -> float:
    """Time of ``part`` during which none of ``others`` runs."""
    busy = union(others)
    return sum(total(gaps(busy, s, e)) for s, e in union(part))


@dataclass
class Op:
    name: str
    start: float
    end: float
    thread: int
    shapes: list
    device_s: float          # device time of the kernels it launched


@dataclass
class Trace:
    """One traced stretch, times in seconds on the profiler's clock."""
    window: Interval
    kernels: List[Tuple[str, float, float]]      # (name, start, end)
    ops: List[Op]
    units: int                                   # steps or requests traced
    extra: Dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_intervals(self) -> List[Interval]:
        return clip([(s, e) for _, s, e in self.kernels], *self.window)

    def busy_s(self) -> float:
        return total(union(self.device_intervals()))

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.kernels:
            key = _short(n)
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest idle stretches, each named by the innermost host op
        running on the stepping thread when the card went idle."""
        merged = union(self.device_intervals())
        longest = sorted(gaps(merged, *self.window),
                         key=lambda g: g[0] - g[1])[:top]
        main = [o for o in self.ops if o.thread == self.extra.get("thread")]
        main.sort(key=lambda o: o.start)
        starts = [o.start for o in main]
        out = []
        for s, e in longest:
            k = bisect.bisect_right(starts, s)
            inner = None
            for o in reversed(main[max(0, k - 4000):k]):
                if o.end > s and (inner is None or o.start > inner.start):
                    inner = o
            label = inner.name if inner is not None else "outside any op"
            out.append([_short("host_in_" + label), e - s])
        return out


def _short(name: str) -> str:
    return "".join(c if c.isalnum() or c in "_.:-" else "_"
                   for c in name)[:64]


def record(fn: Callable[[], int], sync: Callable[[], None],
           shapes: bool = False) -> Trace:
    """Run ``fn`` (which returns the steps or requests it ran) under
    ``torch.profiler`` with CPU and CUDA activities, between two
    synchronizations, and reduce the profile.  ``shapes`` records the
    ops' argument shapes, which slows the host: the busy and idle
    readings come from a stretch without them."""
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        with record_function("bench_window"):
            units = fn()
            sync()
    t0 = time.perf_counter()
    events = prof.events()
    kernels, ops, window = [], [], None
    for e in events:
        s, en = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name == "bench_window":
            if e.device_type == DeviceType.CPU:
                window = (s, en)
        elif e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, s, en))
        else:
            ops.append(Op(e.name, s, en, e.thread, e.input_shapes,
                          e.device_time_total * 1e-6
                          if hasattr(e, "device_time_total")
                          else e.cuda_time_total * 1e-6))
    if window is None:
        raise RuntimeError("the profile holds no bench_window span")
    counts = Counter(o.thread for o in ops)
    thread = counts.most_common(1)[0][0] if counts \
        else threading.get_ident()
    return Trace(window, kernels, ops, units,
                 {"thread": thread, "parse_s": time.perf_counter() - t0,
                  "events": len(events)})
