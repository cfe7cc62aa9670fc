"""The host-loader branch of the port's training run
(``device_data_cache: False``: ``BatchLoader`` batches copied to the
device, the per-step loop with its ``log_every`` fetch) against the JAX
package's, for one epoch, on the CPU from the same weights and data.

Model, data and tolerances as tests/test_torch_main_missing.py (whose
fixtures and comparison this file reuses); the volumes reach the model in
f32 here, without the device cache's bf16 rounding.
"""

from tests.test_torch_main_missing import (  # noqa: F401
    _compare_runs, _drop_checkpoints, _jax_run, _port_run, data_dir, start,
    z_is_the_mean)


def test_host_loader_run_matches_jax(start, data_dir, tmp_path,
                                     z_is_the_mean):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(device_data_cache=False, epochs=1)
    jstate, jsched, jl = _jax_run(start, data_dir, jdir, **kw)
    model, opt, sched, pl, history = _port_run(start, data_dir, pdir, **kw)
    assert type(jl[0]).__name__ == type(pl[0]).__name__ == "BatchLoader"
    try:
        _compare_runs(jdir, pdir, jstate, jsched, model, sched, start[3])
        assert [r["epoch"] for r in history] == [0]
        assert history[0]["steps"] == 2
        assert float(opt.state_dict()["state"][0]["step"]) == 2.0
    finally:
        _drop_checkpoints(jdir, pdir)
