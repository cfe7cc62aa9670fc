"""Model FLOP utilization (%) of the untraced window: the reference's FLOP
per unit of work over its time, against the card's dense peak."""
from benchmark.readers import mfu_pct as read  # noqa: F401
