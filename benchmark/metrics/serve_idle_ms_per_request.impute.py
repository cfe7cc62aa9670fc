"""Idle milliseconds of the card per request inside the program's
``rdt.serve.step`` spans and outside its ``rdt.resize`` spans
(``benchmark/spans.py``)."""
from benchmark.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "rdt.serve.step", "step")
