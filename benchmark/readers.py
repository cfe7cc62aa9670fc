"""What the per-layer metric readers (``metrics/<name>.py``) compute from
a run's context: ``trace`` (a ``trace.Trace`` or None), ``trace_shapes`` (a
shorter stretch that recorded the ops' argument shapes), ``result`` (the
traffic driver's numbers: ``flop_per_unit``, ``unit_s``), ``config`` and
``peak`` (``counts.peaks`` of the card, None for an unknown card).  Each
returns None where it finds nothing to read."""

from __future__ import annotations

from benchmark import counts


def device_idle_pct(ctx):
    """Share of the traced stretch in which no device operation runs."""
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu_pct(ctx):
    """FLOP of a step or request (counted on the reference) over its time
    in the untraced window, over the card's dense peak of the compute
    dtype."""
    res, peak = ctx["result"], ctx["peak"]
    if peak is None or not res.get("unit_s") or not res.get("flop_per_unit"):
        return None
    dtype = ctx["config"].get("compute_dtype", "float32")
    return 100.0 * res["flop_per_unit"] / res["unit_s"] / peak[dtype]


def roofline_pct(ctx, ops):
    """Sum of the least times of the traced calls of ``ops`` over the
    device time of the kernels they launched."""
    tr, peak = ctx["trace_shapes"], ctx["peak"]
    if tr is None or peak is None:
        return None
    dtype = ctx["config"].get("compute_dtype", "float32")
    least = measured = 0.0
    for op in tr.ops:
        if op.name in ops and op.shapes and op.device_s > 0:
            b, f = counts.in_modulate_cost(op.name, op.shapes[0], dtype)
            least += counts.least_time(b, f, peak, dtype)
            measured += op.device_s
    return 100.0 * least / measured if measured > 0 else None


def kernel_ms_per_unit(ctx, words):
    """Device milliseconds per traced step or request in kernels whose
    name holds one of ``words``."""
    tr = ctx["trace"]
    if tr is None or tr.units <= 0:
        return None
    return 1e3 * sum(e - s for n, s, e in tr.kernels
                     if any(w in n for w in words)) / tr.units
