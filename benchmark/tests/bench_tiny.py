"""Shared helpers of the benchmark's CPU tests: a cell shrunk to run on
the CPU in seconds (32x64 planes, a fold of 9 subjects of 20 slices,
batches of 4, float32, one warm-up and one traced step or request, the
first request checked), driven through the same code as on the card."""

from __future__ import annotations

import contextlib
from unittest import mock

import pytest
import torch

SEED = 2147483901


def shrink(rc: dict, traffic: dict) -> None:
    rc.update(input_height=32, input_width=64, compute_dtype="float32",
              epoch_chunk_steps=1)
    rc["data"] = dict(rc["data"], cohort=12, depth=20, slice_range=[5, 15])
    if traffic["kind"] == "train":
        a = traffic["effective_batch"] // traffic["batch_size"]
        rc["batch_size"], rc["effective_batch"] = 4, 4 * a
    else:
        traffic.update(batch=4)


@contextlib.contextmanager
def tiny_drivers():
    """The drivers' own counts cut to what a 0.01-s window reaches."""
    from benchmark import drive_impute, drive_train
    with mock.patch.multiple(drive_train, WARM_STEPS=1, TRACED_STEPS=1), \
            mock.patch.multiple(drive_impute, SLOTS=8, CHECK_SPAN=1,
                                CHECK_REQUESTS=1, TRACED_REQUESTS=1):
        yield


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run_tiny(workload: str, trace: bool = False, seed: int = SEED):
    from benchmark.run import run_cell
    with tiny_drivers():
        return run_cell(workload, seed, 0.01, trace, "cpu", shrink)
