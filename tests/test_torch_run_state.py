"""The port's run state against the JAX package's, on the CPU, with no
model: ``stat.csv``, checkpoints and the shape-tolerant merge, the
preemption helpers, the run directory and config snapshots, and the step
timer.

Tolerance: none.  ``stat.csv`` must be byte-equal to the file the JAX
package writes with pandas; counts, decisions and snapshot values must be
equal."""

import os
import signal

import numpy as np
import pytest
import torch

from representation_disentanglement_tpu import config as jconfig
from representation_disentanglement_tpu.training import (
    checkpoint as jckpt, stats as jstats)
from representation_disentanglement_tpu.utils import (
    preempt as jpreempt, profiling as jprofiling)
from representation_disentanglement_torch import config
from representation_disentanglement_torch.training import checkpoint, stats
from representation_disentanglement_torch.utils import preempt, profiling

STATS = [
    ({"recon_x": 0.5, "psnr": float("-inf"), "ssim": float("nan"),
      "all": 3.0, "latent_z": 1e-7, "kl": 0.0}, "epoch[ 0]"),
    ({"recon_x": np.float32(0.1), "psnr": 27.25, "ssim": 0.9, "all": 1e17,
      "latent_z": -2.5e-300, "kl": float("inf")}, "val"),
    ({"recon_x": 1, "psnr": 1 / 3, "ssim": 123456789.123, "all": 0.0,
      "latent_z": np.float64(7.0), "kl": -0.0}, 'quoted, "info"'),
]


def test_stat_csv_is_byte_equal_to_jax(tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    for stat, info in STATS:
        jstats.save_result_stat(stat, str(jdir), info=info)
        stats.save_result_stat(stat, str(pdir), info=info)
    got = (pdir / "stat.csv").read_bytes()
    assert got == (jdir / "stat.csv").read_bytes()
    assert b",-inf," in got and b"1e-07" in got
    assert b"0.5,\n0,val" in got            # NaN: an empty last field


def _state(seed, shape=(3, 4)):
    g = torch.Generator().manual_seed(seed)
    return {"enc.weight": torch.randn(shape, generator=g),
            "enc.bias": torch.randn(4, generator=g),
            "bn.running_mean": torch.randn(4, generator=g),
            "dec.weight": torch.randn(2, 4, generator=g)}


def test_checkpoint_round_trip_best_copy_and_atomic_write(tmp_path):
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), amsgrad=True)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    payload = {"epoch": 7, "monitor_metric": 0.25,
               "stat": {"psnr": float("-inf"), "recon_x": 0.5},
               "params": model.state_dict(), "opt_state": opt.state_dict(),
               "scheduler": {"lr": 2e-4, "best": float("inf"),
                             "num_bad_epochs": 0}}
    d = str(tmp_path)
    path = checkpoint.save_checkpoint(payload, True, d)
    assert os.path.basename(path) == "epoch007.ckpt"
    assert sorted(os.listdir(d)) == ["epoch007.ckpt", "model_best.ckpt"]
    with open(path, "rb") as a, open(os.path.join(d, "model_best.ckpt"),
                                      "rb") as b:
        assert a.read() == b.read()
    back = checkpoint.load_checkpoint(d, "epoch007.ckpt")
    assert back["epoch"] == 7 and back["stat"] == payload["stat"]
    assert back["scheduler"] == payload["scheduler"]
    for k, v in payload["params"].items():
        assert torch.equal(back["params"][k], v)
    opt2 = torch.optim.Adam(torch.nn.Linear(4, 3).parameters(), amsgrad=True)
    opt2.load_state_dict(back["opt_state"])
    assert float(opt2.state_dict()["state"][0]["step"]) == 1.0
    checkpoint.save_checkpoint({"epoch": 8}, False, d, name="preempt.ckpt")
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    with pytest.raises(ValueError, match="No correct checkpoint"):
        checkpoint.load_checkpoint(d, "missing.ckpt")
    # what the loader refuses: a payload that is not plain data
    torch.save({"epoch": object()}, os.path.join(d, "bad.ckpt"))
    with pytest.raises(Exception):
        checkpoint.load_checkpoint(d, "bad.ckpt")


def test_load_partial_params_matches_jax_rule():
    cur, saved = _state(0), _state(1, shape=(4, 3))    # one reshaped tensor
    del saved["dec.weight"]
    saved["extra.weight"] = torch.zeros(2)
    merged, n_res, n_tot = checkpoint.load_partial_params(cur, saved)
    nest = lambda sd: {k.split(".")[0]: {kk.split(".")[1]: v.numpy()
                                         for kk, v in sd.items()
                                         if kk.split(".")[0] == k.split(".")[0]}
                       for k in sd}
    jmerged, jn_res, jn_tot = jckpt.load_partial_params(nest(cur),
                                                        nest(saved))
    assert (n_res, n_tot) == (jn_res, jn_tot) == (2, 4)
    for k, v in merged.items():
        a, b = k.split(".")
        np.testing.assert_array_equal(v.numpy(), np.asarray(jmerged[a][b]))
    assert merged["enc.weight"] is cur["enc.weight"]
    assert merged["enc.bias"] is saved["enc.bias"]
    assert checkpoint.load_partial_params(cur, None)[1:] == (0, 4)


def test_restore_model_state(tmp_path):
    d = str(tmp_path)
    checkpoint.save_checkpoint({"epoch": 2, "params": _state(1)}, False, d,
                               name="x.ckpt")
    ckpt, merged, n_res, n_tot = checkpoint.restore_model_state(
        _state(0), d, "x.ckpt")
    assert ckpt["epoch"] == 2 and (n_res, n_tot) == (4, 4)
    assert all(torch.equal(merged[k], v) for k, v in _state(1).items())


def _preempt_trace(mod, ckpt_mod, d):
    """The sequences of tests/test_preempt.py, recording each decision."""
    def mini(name, epoch):
        ckpt_mod.save_checkpoint({"epoch": epoch, "params": {}}, False, d,
                                 name=name)

    def pick():
        name, pre = mod.latest_resume_checkpoint(d, "model_best.ckpt")
        return name, None if pre is None else int(pre["epoch"])

    out = [pick()]
    mini("model_best.ckpt", 3)
    mini(mod.PREEMPT_NAME, 5)
    out.append(pick())
    mini(mod.PREEMPT_NAME, 1)
    out.append(pick())
    os.remove(os.path.join(d, "model_best.ckpt"))
    out.append(pick())
    for e in (1, 2, 2):
        mod.clear_stale_preempt(d, e)
        out.append(os.path.exists(mod.preempt_path(d)))
    with open(mod.preempt_path(d), "wb") as f:
        f.write(b"not a checkpoint")
    out.append(mod._preempt_epoch(d) > 10**9)
    mod.clear_stale_preempt(d, 999)
    out.append(os.path.exists(mod.preempt_path(d)))
    mod.tag_preempt_epoch(d, 7)
    out.append(mod._preempt_epoch(d))
    out.append(os.path.exists(mod.preempt_path(d) + ".epoch.tmp"))
    mod.drop_preempt_sidecar(d)
    out.append(mod._preempt_epoch(d) > 10**9)
    mini(mod.PREEMPT_NAME, 4)
    for e in (4, 5):
        mod.clear_stale_preempt(d, e)
        out.append(os.path.exists(mod.preempt_path(d)))
    return out


def test_preempt_helpers_match_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _preempt_trace(jpreempt, jckpt, str(tmp_path / "jax"))
    got = _preempt_trace(preempt, checkpoint, str(tmp_path / "port"))
    assert got == want
    assert want[1] == (preempt.PREEMPT_NAME, 5)
    assert preempt.PREEMPT_NAME == jpreempt.PREEMPT_NAME


def test_guard_catches_signal_and_restores_handlers():
    prev = signal.getsignal(signal.SIGTERM)
    with preempt.PreemptionGuard() as g:
        assert not g.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested
    assert signal.getsignal(signal.SIGTERM) is prev
    g = preempt.PreemptionGuard()
    g.request()
    assert g.requested


_SHARED = dict(contrast_list=["T1", "T2"], batch_size=4, epochs=3,
               model_name="MultimodalModel", lr=1e-3, fold=2)


def test_snapshot_txt_lines_are_jax_lines(tmp_path):
    pcfg = config.Config(**_SHARED).derive()
    jcfg = jconfig.Config(**_SHARED).derive()
    pcfg.snapshot_txt(str(tmp_path / "port"))
    jcfg.snapshot_txt(str(tmp_path / "jax"))
    got = (tmp_path / "port" / "config.txt").read_text().splitlines()
    want = set((tmp_path / "jax" / "config.txt").read_text().splitlines())
    assert got and not [line for line in got if line not in want]


def test_resolve_run_and_merge_saved_match_jax(tmp_path):
    root = str(tmp_path)
    pcfg = config.Config(**_SHARED, continue_train=True,
                         ckpt_timelabel="t1").derive()
    pcfg = config.resolve_run(pcfg, ckpt_root=root)
    assert pcfg.ckpt_path == os.path.join(root, "BraTS", "MultimodalModel",
                                          "t1")
    fresh = config.resolve_run(config.Config(**_SHARED).derive(), root)
    lt = fresh.ckpt_path.split(os.sep)[-1].split("_")
    assert len(lt) == 5 and all(p.isdigit() for p in lt)
    snap = os.path.join(pcfg.ckpt_path, "config.yaml")
    # the JAX package reads the port's snapshot as YAML
    jloaded = jconfig.load_config(snap)
    for k, v in pcfg.to_dict().items():
        assert getattr(jloaded, k) == v, k

    # a resumed run in the same directory: saved values win, live keys stay
    for mod in (config, jconfig):
        for src in ("port", "jax"):
            run_dir = os.path.join(root, src)
            saved = (config if src == "port" else jconfig).Config(
                **_SHARED).derive()
            saved.snapshot_yaml(run_dir)
            live = mod.Config(contrast_list=["T1"], batch_size=2,
                              phase="test", continue_train=True,
                              ckpt_timelabel="x").derive()
            live.ckpt_path = run_dir
            with open(os.path.join(run_dir, "config.yaml")) as f:
                text = f.read()
            data = config._read_snapshot(os.path.join(run_dir,
                                                      "config.yaml"))
            import yaml
            assert data == yaml.safe_load(text)
            live.merge_saved(data)
            assert live.contrast_list == ["T1", "T2"] and live.batch_size == 4
            assert live.phase == "test" and live.continue_train is True
            assert live.in_num_ch == 14                 # derive() re-ran

    # resolve_run merges an existing directory's snapshot in both packages
    for mod in (config, jconfig):
        cfg = mod.Config(contrast_list=["T1"], continue_train=True,
                         ckpt_timelabel="t1").derive()
        cfg = mod.resolve_run(cfg, ckpt_root=root)
        assert cfg.ckpt_path == pcfg.ckpt_path
        assert cfg.contrast_list == ["T1", "T2"] and cfg.continue_train


def test_step_timer_matches_jax(monkeypatch):
    ticks = iter([0.0, 1.0, 1.5, 2.5, 10.0, 10.25, 10.75, 11.0])
    clock = {}

    def fake():
        return clock["t"]

    monkeypatch.setattr(profiling.time, "perf_counter", fake)
    timers = (profiling.StepTimer(warmup=1), jprofiling.StepTimer(warmup=1))
    for i, t in enumerate(ticks):
        clock["t"] = t
        if i == 4:
            for tm in timers:
                tm.reset_interval()
        outs = [tm.step(16) for tm in timers]
        assert outs[0] == outs[1]
    assert timers[0].summary() == timers[1].summary()
    assert len(timers[0].times) == 4
    assert timers[0].throughput == 64 / 2.25
