"""Interpolation matrices copied to the card per optimizer step: the
program's ``rdt.resize.upload`` spans on the stepping thread
(``benchmark/spans.py``)."""
from benchmark.spans import spans_per_unit


def read(ctx):
    return spans_per_unit(ctx, "rdt.train.step", "rdt.resize.upload")
