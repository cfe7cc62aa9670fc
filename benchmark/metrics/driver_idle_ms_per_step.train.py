"""Idle milliseconds of the card per optimizer step outside the program's
``rdt.train.step`` spans: the run driver's planning, gather, stacking and
chunk loop (``benchmark/spans.py``)."""
from benchmark.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "rdt.train.step", "driver")
