"""Step timing, traces and device memory (the JAX package's
``utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` context (CPU activity, and the
  card's where there is one) that writes one Chrome trace,
  ``<logdir>/trace.json``, when it closes (JAX: a ``jax.profiler`` trace
  directory for TensorBoard);
- ``span(name)``: a named interval of host time in whatever profile is
  being recorded (the spans are listed below);
- ``device_memory_stats()``: one dict per visible card, the bytes in use
  and the peak in MiB, from ``torch.cuda.memory_stats`` (JAX: each local
  device's ``memory_stats``);
- ``StepTimer``;
- ``dense_peak(name, dtype)``: the card's published dense peak in
  operations per second for a compute dtype, by the name
  ``torch.cuda.get_device_name`` gives (``DENSE_PEAKS``; None for a card
  the table does not know).  ``bench.py``, ``bench3d.py`` and
  ``chip_smoke.py`` take their peaks from it.

``StepTimer`` reads the host clock between calls of ``step`` and never
synchronizes the card: the host-loader loop calls it after each step is
queued, so in a steady state it measures the rate at which the card
drains the queue, and the loop's metric fetch every ``log_every`` steps is
where it waits, as the JAX loop waits at its fetch.

A span is a ``torch.profiler.record_function`` range, so it lands on the
clock of the profile's kernels: in ``trace``'s Chrome trace and in any
other ``torch.profiler`` recording.  It records exactly when a profiler
records; otherwise, and while ``torch.compile`` or ``torch.export``
traces, it costs one check and enters nothing (an ungated
``record_function`` costs some 11 µs on a host core, and a step opens a
few hundred spans).  The spans the port opens:

- ``rdt.train.step``: one optimizer step of ``training.train.
  make_train_step`` (every microbatch and Adam), or of ``training.
  train3d``'s 3D steps;
- ``rdt.step.forward``: a microbatch's ``prepare_batch`` and loss;
- ``rdt.step.backward``: its backward, the data-parallel all-reduce and
  the clip;
- ``rdt.step.optimizer``: Adam, the discriminator's Adam and the restore
  of frozen parameters;
- ``rdt.load3d``: one 3D step's host batches sampled, collated and
  copied to the card (``training.train3d.train_loop_3d``);
- ``rdt.serve.step``: one request of ``serve.make_serve_step`` or
  ``make_serve_step_retrieval``;
- ``rdt.resize``: one ``ops.resize.bilinear_resize`` that resizes;
- ``rdt.resize.upload``: one interpolation matrix copied to the tensor's
  device (their number is the count of uploads).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

# Dense peaks (no sparsity) of each H100 variant, operations per second,
# from NVIDIA's data sheets: bf16 on the tensor cores, and float32 outside
# them (TF32 off).  Keys are matched as substrings of the device name; the
# SXM part names itself "NVIDIA H100 80GB HBM3".
DENSE_PEAKS = (
    ("H100 80GB HBM3", {"bfloat16": 989.4e12, "float32": 66.9e12}),
    ("H100 PCIe", {"bfloat16": 756e12, "float32": 51.2e12}),
    ("H100 NVL", {"bfloat16": 835e12, "float32": 60e12}),
)


def dense_peak(name: str, dtype: str) -> Optional[float]:
    """The dense peak of ``dtype`` ('bfloat16' | 'float32') on the card
    called ``name``, or None when ``DENSE_PEAKS`` does not know the card.
    Raises ValueError for another dtype."""
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype {dtype!r}: bfloat16 or float32")
    for key, peaks in DENSE_PEAKS:
        if key in name:
            return peaks[dtype]
    return None


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``<logdir>/trace.json`` at the end.  Yields the profiler (its
    ``key_averages()`` sum the ops)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a ``record_function`` range
    while a profiler records and nothing compiles, and does nothing
    otherwise."""
    if torch.autograd._profiler_enabled() \
            and not torch.compiler.is_compiling():
        return torch.profiler.record_function(name)
    return _OFF


def device_memory_stats() -> List[Dict[str, float]]:
    """[{device, bytes_in_use, peak_bytes_in_use}] per visible card, the
    sizes in MiB (an empty list without a card)."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        s = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
                    "bytes_in_use": s.get("allocated_bytes.all.current", 0)
                    / 2 ** 20,
                    "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0)
                    / 2 ** 20})
    return out


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
