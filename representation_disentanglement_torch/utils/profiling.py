"""Step timing (the ``StepTimer`` of the JAX package's
``utils/profiling.py``).

``StepTimer`` reads the host clock between calls of ``step`` and never
synchronizes the card: the host-loader loop calls it after each step is
queued, so in a steady state it measures the rate at which the card
drains the queue, and the loop's metric fetch every ``log_every`` steps is
where it waits, as the JAX loop waits at its fetch.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class StepTimer:
    """Step-time meter: call .step(n_samples) once per optimizer step."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self.samples = 0
        self._last: Optional[float] = None
        self._count = 0

    def reset_interval(self) -> None:
        """Call at epoch start so that cross-epoch gaps (validation,
        checkpoint I/O) stay out of the step-interval statistics."""
        self._last = None
        self._count = 0

    def step(self, n_samples: int) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                dt = now - self._last
                self.times.append(dt)
                self.samples += n_samples
        self._last = now
        return dt

    @property
    def mean_step_time(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def throughput(self) -> float:
        tot = sum(self.times)
        return self.samples / tot if tot else 0.0

    def summary(self) -> Dict[str, float]:
        return {"mean_step_time_s": self.mean_step_time,
                "samples_per_sec": self.throughput,
                "steps_measured": float(len(self.times))}
