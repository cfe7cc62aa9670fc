"""The 3D path's shared step loop (``training.train3d.train_loop_3d``) and
its profiler spans, on the CPU, port only: NVNet3D at 16x16x16, 2
contrasts, 8 filters, batch 1, over a fixed list of host batches.

The loop yields what ``main_3d._train``'s inline loop computed before it
was shared (written out below as it stood): the same metrics, step by
step, with and without accumulation, and the same leftover message.
Under ``torch.profiler`` each step opens one ``rdt.train.step`` holding
one ``rdt.step.forward`` and ``rdt.step.backward`` per microbatch and one
``rdt.step.optimizer``; the loop opens ``rdt.load3d`` around each step's
batches and copy, outside the step's span.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from representation_disentanglement_torch.models.unet3d import build_nvnet3d
from representation_disentanglement_torch.training.train3d import (
    METRIC_KEYS, create_state_3d, make_train_step_3d, train_loop_3d)

HWD, M = (16, 16, 16), 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _batches(n):
    rs = np.random.default_rng(0)
    return [{"inputs": rs.normal(size=(1, M, *HWD)).astype(np.float32),
             "targets": rs.integers(0, 4, (1, 1, *HWD)).astype(np.float32)}
            for _ in range(n)]


def _step(accum):
    model = build_nvnet3d(HWD, M, 3, 8, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    return make_train_step_3d(model, create_state_3d(model), accum=accum)


def _inline_loop(step, batches, accum, generator):
    """``main_3d._train``'s loop body before ``train_loop_3d``."""
    terms, micro = [], []
    for batch in batches:
        micro.append(batch)
        if len(micro) < accum:
            continue
        stack = lambda k: torch.as_tensor(
            micro[0][k] if accum == 1
            else np.stack([m[k] for m in micro]), device="cpu")
        m = step({"inputs": stack("inputs"), "targets": stack("targets")},
                 generator)
        micro = []
        mvals = torch.stack([m[k] for k in METRIC_KEYS]).cpu().numpy()
        terms.append(dict(zip(METRIC_KEYS, map(float, mvals))))
    if micro:
        print(f"[accum] dropping {len(micro)} leftover microbatch(es) "
              "at epoch end (epoch yielded a non-multiple of --accum)")
    return terms


@pytest.mark.parametrize("accum", [1, 2])
def test_loop_yields_what_the_inline_loop_did(accum, capsys):
    batches = _batches(5)
    want = _inline_loop(_step(accum), batches, accum,
                        torch.Generator().manual_seed(7))
    said = capsys.readouterr().out
    got = list(train_loop_3d(_step(accum), iter(batches), accum, "cpu",
                             torch.Generator().manual_seed(7)))
    assert got == want and len(got) == 5 // accum
    assert capsys.readouterr().out == said
    assert ("dropping 1 leftover" in said) == (accum == 2)


def test_a_non_finite_metric_raises():
    batches = _batches(2)
    batches[1]["inputs"][0, 0, 0, 0, 0] = np.nan
    loop = train_loop_3d(_step(1), iter(batches), 1, "cpu", epoch=4)
    assert np.isfinite(next(loop)["loss"])
    with pytest.raises(FloatingPointError, match="epoch 4 step 1"):
        next(loop)


def _spans(prof, name):
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == name)


@pytest.mark.parametrize("accum", [1, 2])
def test_spans_of_the_step_and_the_loader(accum):
    n = 2
    loop = train_loop_3d(_step(accum), iter(_batches(n * accum)), accum,
                         "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert len(list(loop)) == n
    steps = _spans(prof, "rdt.train.step")
    assert len(steps) == n
    inner = {k: _spans(prof, f"rdt.step.{k}")
             for k in ("forward", "backward", "optimizer")}
    assert [len(v) for v in inner.values()] == [n * accum, n * accum, n]
    for spans in inner.values():
        assert all(any(a <= s and e <= b for a, b in steps)
                   for s, e in spans)
    loads = _spans(prof, "rdt.load3d")
    assert len(loads) == n + 1          # the last finds the batches ended
    assert all(e <= a or s >= b for s, e in loads for a, b in steps)
    # each step's load comes before it
    assert all(loads[k][1] <= steps[k][0] for k in range(n))
