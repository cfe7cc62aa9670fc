"""Share of its roofline (%) that the SPADE interior's forward reaches in
imputation (rdt::in_modulate calls of the traced requests)."""
from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("rdt::in_modulate",))
