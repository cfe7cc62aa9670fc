"""Idle milliseconds of the card per optimizer step inside the program's
``rdt.train.step`` spans and outside its ``rdt.resize`` spans
(``benchmark/spans.py``)."""
from benchmark.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "rdt.train.step", "step")
