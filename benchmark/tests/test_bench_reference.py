"""The comparison that decides ``correct``, on the CPU at a tiny size: the
program's timed path agrees with the plain reference on the same seeded
inputs, and a run whose timed path is broken underneath, or the control
in the program's place, comes out not correct."""

import numpy as np
import pytest
import torch

from benchmark.tests.bench_tiny import (SEED, few_threads, run_tiny,  # noqa: F401
                                        shrink, tiny_drivers)

TRAIN = ("flagship-train-b64", "zerodose-train-b64x2")
IMPUTE = "flagship-impute-b64"


@pytest.mark.parametrize("workload", TRAIN)
def test_train_epoch_matches_the_reference(workload, few_threads):
    """float32 on both sides: the first step's loss terms and the median
    leaf's first gradient agree to float32 rounding, which the kinks (max
    pooling, the hinges) and the other order of the sums lift to some 1e-4
    at this size (bf16 on the card reads 2e-3 to 1e-2).  The change after
    three Adam steps moves each element by about lr whatever its
    gradient's size, so round-off in small gradients reads up to 1e-2
    here too; it is held to the cell's limit only."""
    out = run_tiny(workload)
    r = out["readings"]
    assert out["correct"], out["checks"]
    assert r["terms_step1_max"] < 2e-3
    assert r["grad_gap_median"] < 2e-3


def test_serve_step_matches_the_reference(few_threads):
    out = run_tiny(IMPUTE)
    assert out["correct"], out["checks"]
    assert out["readings"]["xhat_gap"] < 1e-4
    assert out["readings"]["y_gap"] < 1e-4


def _frozen_optimizer(monkeypatch):
    from representation_disentanglement_torch.training import optim
    make = optim.make_optimizer

    def frozen(params, cfg):
        opt = make(params, cfg)
        opt.step = lambda *a, **k: None
        return opt
    monkeypatch.setattr(optim, "make_optimizer", frozen)


def _half_batch(monkeypatch):
    from representation_disentanglement_torch.training import epoch
    gather = epoch.gather_blocks

    def half(vols, tgts, presence, rows, slices, drop, block_size):
        n = rows.shape[0] // 2
        return gather(vols, tgts, presence, rows[:n], slices[:n], drop[:n],
                      block_size=block_size)
    monkeypatch.setattr(epoch, "gather_blocks", half)


@pytest.mark.parametrize("fault", [_frozen_optimizer, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", TRAIN)
def test_a_broken_train_step_is_not_correct(workload, fault, monkeypatch,
                                            few_threads):
    fault(monkeypatch)
    out = run_tiny(workload)
    assert not out["correct"], out["checks"]


def test_an_altered_answer_is_not_correct(monkeypatch, few_threads):
    from representation_disentanglement_torch import serve
    make = serve.make_serve_step

    def altered(model, cfg, source, with_y=True):
        step = make(model, cfg, source, with_y)

        def run(*a):                 # each answer is its neighbour's
            x_hat, y = step(*a)
            return x_hat.roll(1, dims=1), y.roll(1, dims=0)
        return run
    monkeypatch.setattr(serve, "make_serve_step", altered)
    out = run_tiny(IMPUTE)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAIN + (IMPUTE,))
def test_the_control_is_not_correct(workload, few_threads):
    """The reference with its products' operands in float8, put in the
    program's place, fails a limit of the cell."""
    from benchmark import compare
    from benchmark.control import _cell, impute_readings, train_readings
    rc, traffic = _cell(workload)
    shrink(rc, traffic)
    fn = train_readings if traffic["kind"] == "train" else impute_readings
    with tiny_drivers():
        readings = fn(rc, traffic, SEED, ["control"], torch.device("cpu"))
    ok, checks = compare.judge(readings["control"],
                               compare.limits(workload), 0)
    assert not ok, checks


def test_the_reference_plan_is_the_programs():
    """The reference works the epoch's plan out again from the seeds: the
    same rows, slices, dropoff and pairs as ``epoch_indices``."""
    from representation_disentanglement_torch.data.device_store import (
        DeviceBatchLoader, DeviceVolumeCache)
    from representation_disentanglement_torch.training.epoch import (
        epoch_indices)

    from benchmark.control import _cell
    from benchmark.drive_train import plan_rows
    from benchmark.inputs import slice_rows
    rc, traffic = _cell("zerodose-train-b64x2")
    shrink(rc, traffic)
    subj, sl = slice_rows(rc)
    S, M = subj.max() + 1, len(rc["contrast_list"])
    presence = torch.ones(S, M)
    presence[1, 0] = 0
    vols = torch.zeros(S, M, 20, 2, 2)
    names = [f"s{i}" for i in range(S)]
    cache = DeviceVolumeCache(vols, torch.zeros(S, 20, 2, 2), presence,
                              names, 3, 20)
    loader = DeviceBatchLoader(cache, [names[i] for i in subj], sl, 4,
                               shuffle=True, drop_last=True, dropoff=True,
                               seed=7)
    plan = epoch_indices(loader, 2, M, np.random.default_rng(8))
    rows, slices, drop, sim = plan_rows(rc, 7, 8, plan.steps,
                                        presence.numpy())
    assert np.array_equal(plan.rows.numpy(), rows)
    assert np.array_equal(plan.slices.numpy(), slices)
    assert np.array_equal(plan.drop.numpy(), drop)
    assert np.array_equal(plan.sim, np.array(sim))
