"""The port's profiler spans (``utils/profiling.span``) on the CPU.

Model: the flagship structure at M=2 (T1 and T2), 32x64, B=2, plain
convolutions, f32; data: random volumes in a device volume cache of two
subjects, an epoch plan of two optimizer steps.  Under
``torch.profiler.profile(activities=[CPU])`` one ``train_epoch`` chunk of
two steps opens one ``rdt.train.step`` per step, one ``rdt.step.forward``
and ``rdt.step.backward`` per microbatch inside it, one
``rdt.step.optimizer`` per step, every ``rdt.resize`` inside a forward,
and, from an empty matrix cache, as many ``rdt.resize.upload`` as the
cache counts misses, all in the first step; each serve step opens one
``rdt.serve.step``.  With no profiler, or while compiling, no span enters
``record_function``; the AOT export of the serve step holds no profiler
op, even when a profiler records around it, and leaves the matrix cache
as it found it.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from representation_disentanglement_torch import serve
from representation_disentanglement_torch.config import Config
from representation_disentanglement_torch.data.device_store import (
    DeviceBatchLoader, DeviceVolumeCache)
from representation_disentanglement_torch.models.multimodal import (
    build_model)
from representation_disentanglement_torch.ops import resize
from representation_disentanglement_torch.training import epoch, optim
from representation_disentanglement_torch.utils import aot, profiling

M, B, H, W, S, D = 2, 2, 32, 64, 2, 12
BASE = dict(contrast_list=["T1", "T2"], input_height=H, input_width=W,
            batch_size=B, use_pallas=True, notshared_impl="loop",
            is_cond=False,
            others={"mod_enc_s": False, "ana_dec_act": "softmax",
                    "old": False, "softmax_remove_mask": True})
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfg(A=1):
    return Config(**dict(BASE, effective_batch=A * B)).derive().validate()


def _trainer(A):
    """A model, its ``train_epoch`` and a plan of ``STEPS`` steps of A
    microbatches over a cache of random volumes."""
    torch.manual_seed(0)
    cfg = _cfg(A)
    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    cache = DeviceVolumeCache(torch.randn(S, M, D, H, W, generator=g),
                              torch.rand(S, D, H, W, generator=g),
                              torch.ones(S, M), ["a", "b"], cfg.block_size,
                              D)
    n = STEPS * A * B
    loader = DeviceBatchLoader(cache, ["a", "b"] * (n // 2),
                               list(range(4, 4 + n)), B, shuffle=True,
                               drop_last=True, seed=2)
    opt = optim.make_optimizer(model.parameters(), cfg)
    train_epoch, n_micro = epoch.make_train_epoch(model, cfg, opt, cache,
                                                  None)
    plan = epoch.epoch_indices(loader, n_micro, M, np.random.default_rng(3))
    assert n_micro == A and plan.steps == STEPS
    return cfg, model, train_epoch, plan


def _request(seed=0):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(M, B, H, W, 7)).astype(np.float32)
    x[0, 1] = 0.0                             # contrast 0 missing in row 1
    mask = np.ones((B, M), np.float32)
    mask[1, 0] = 0.0
    mask_img = (x[1, :, :, :, 0] == 0).astype(np.float32)
    return dict(inputs=x, mask=mask, mask_img=mask_img)


def _spans(prof):
    """{name: [(start, end, thread)]} of the profile's ``rdt.`` ranges,
    from the raw events (``prof.events()`` would build the whole event
    tree first, seconds for a train step)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("rdt."):
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.end_ns(), e.start_thread_id()))
    return out


def _inside(child, parents):
    s, e, t = child
    return any(ps <= s and e <= pe and pt == t for ps, pe, pt in parents)


@pytest.mark.parametrize("A", [1, 2])
def test_train_spans_per_step_and_microbatch(A):
    _, _, train_epoch, plan = _trainer(A)
    resize.clear_matrix_cache()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_epoch(plan, first_chunk=True)
    sp = _spans(prof)
    steps = sp["rdt.train.step"]
    assert len(steps) == STEPS
    assert len(sp["rdt.step.optimizer"]) == STEPS
    for name in ("rdt.step.forward", "rdt.step.backward"):
        assert len(sp[name]) == STEPS * A, name
    for name in ("rdt.step.forward", "rdt.step.backward",
                 "rdt.step.optimizer"):
        assert all(_inside(c, steps) for c in sp[name]), name
    for s, e, t in steps:      # each step holds A forwards and backwards
        for name in ("rdt.step.forward", "rdt.step.backward"):
            assert sum(_inside(c, [(s, e, t)]) for c in sp[name]) == A
    assert sp["rdt.resize"]
    assert all(_inside(c, sp["rdt.step.forward"]) for c in sp["rdt.resize"])
    # an upload is a cache miss, and the first step makes every matrix
    uploads = sp["rdt.resize.upload"]
    assert len(uploads) == resize.matrix_cache_info()["misses"] > 0
    assert all(_inside(c, sp["rdt.resize"]) for c in uploads)
    first = min(steps)
    assert all(_inside(c, [first]) for c in uploads)
    assert set(sp) == {"rdt.train.step", "rdt.step.forward",
                       "rdt.step.backward", "rdt.step.optimizer",
                       "rdt.resize", "rdt.resize.upload"}


def _serve_steps():
    """The plain serve step and the retrieval step (a bank of the
    request's own anatomy and random z), with their extra arguments."""
    torch.manual_seed(0)
    cfg = _cfg()
    model = build_model(cfg, device="cpu").eval()
    req = _request()
    with torch.no_grad():
        s = model.encode_anatomy(torch.as_tensor(req["inputs"]),
                                 torch.as_tensor(req["mask_img"]))
    s_list = s.permute(1, 0, 4, 2, 3).numpy()
    z_list = np.random.default_rng(4).normal(
        size=(B, M, cfg.z_size)).astype(np.float32)
    bank = serve.load_z_bank(None, cfg, 1, bank=(s_list, z_list),
                             device="cpu")
    return {"plain": (serve.make_serve_step(model, cfg, 1), ()),
            "retrieval": (serve.make_serve_step_retrieval(
                model, cfg, 1, [0], "nearest_neighbour"), bank)}


@pytest.mark.parametrize("kind", ["plain", "retrieval"])
def test_one_serve_span_per_call(kind):
    step, extra = _serve_steps()[kind]
    req = _request()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            step(req["inputs"], req["mask"], req["mask_img"], *extra)
    sp = _spans(prof)
    assert len(sp["rdt.serve.step"]) == 3
    assert all(_inside(c, sp["rdt.serve.step"]) for c in sp["rdt.resize"])


def test_no_profiler_no_record_function(monkeypatch):
    """Without a profiler the train and serve steps enter no
    ``record_function``; under one, neither does a span while
    compiling."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    _, model, train_epoch, plan = _trainer(1)
    train_epoch(plan.chunk(0, 1), first_chunk=True)
    step, _ = _serve_steps()["plain"]
    req = _request()
    step(req["inputs"], req["mask"], req["mask_img"])
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("rdt.train.step"):
            pass
    assert not _spans(prof)


def test_aot_export_holds_no_profiler_op(monkeypatch):
    """The serve step exports, with a profiler recording around the
    export, and its program holds no profiler op; the export neither
    reads nor fills the resize matrix cache."""
    cfg = _cfg()
    model = build_model(cfg, device="cpu").eval()
    programs = []
    export = torch.export.export

    def kept(*args, **kw):
        programs.append(export(*args, **kw))
        return programs[-1]
    monkeypatch.setattr(torch.export, "export", kept)
    before = resize.matrix_cache_info()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blob = aot.export_serve_step(model, cfg, source=1,
                                     sample=_request())
    assert blob.startswith(aot.MAGIC) and not _spans(prof)
    assert resize.matrix_cache_info() == before
    (program,) = programs
    ops = [str(n.target) for n in program.graph.nodes]
    assert {"aten.einsum.default", "rdt.in_modulate.default"} <= set(ops)
    assert not [o for o in ops if "profiler" in o]
