"""Idle share of the card over the traced stretch (%): the union of the
device's operations against the stretch's length."""
from benchmark.readers import device_idle_pct as read  # noqa: F401
