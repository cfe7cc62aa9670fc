"""Share of its roofline (%) that the SPADE interior reaches in training:
the least time of every traced rdt::in_modulate and rdt::in_modulate_bwd
call, from their argument shapes, over the device time of the kernels
those ops launched."""
from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("rdt::in_modulate", "rdt::in_modulate_bwd"))
