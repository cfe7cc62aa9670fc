"""The port's training run with ``fuse_bn`` against the unfused
BatchNorm, for one epoch on the CPU from the same weights and z noise.

Model, data and fixtures as tests/test_torch_main_missing.py (whose
fixtures and helpers this file reuses); tolerance in the test's
docstring.
"""

import os

import numpy as np

from tests.test_torch_main_missing import (  # noqa: F401
    _drop_checkpoints, _port_run, _read_stat, data_dir, start)


def test_fused_bn_run_matches_unfused(start, data_dir, tmp_path):
    """One epoch with ``fuse_bn`` (on the CPU: the fused pass's plain
    version and its plain backward) against the unfused BatchNorm, from the
    same weights and z noise: stat.csv rtol 1e-4 (the same f32 arithmetic
    in another order; measured at most 1.1e-5)."""
    rows = []
    for fused in (False, True):
        d = str(tmp_path / f"fused{fused}")
        model, *_ = _port_run(start, data_dir, d, epochs=1, fuse_bn=fused)
        rows.append(_read_stat(os.path.join(d, "stat.csv")))
        _drop_checkpoints(d)
    (head0, r0), (head1, r1) = rows
    assert head0 == head1 and [r[0] for r in r0] == [r[0] for r in r1]
    for (info, a), (_, b) in zip(r0, r1):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7, err_msg=info)
