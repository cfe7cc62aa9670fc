"""The port's fused BatchNorm training pass (ops/fused_bn.py) against the
JAX package's ``ops/pallas_bn.bn_train_fused``, on the CPU.

The JAX side runs through ``jax.vjp``: on the CPU its forward takes
``_bn_train_xla`` and its backward the custom ``_bwd``, the fused path's
math; with ``pallas_bn._FORCE_INTERPRET`` patched to True its forward runs
the Pallas kernels K6 (``_stats_kernel``) and K7 (``_norm_kernel``) in
interpret mode, with their block-by-block accumulation.  The port takes
``bn_train_fused_plain`` (autograd gives its gradients) and, for the
gradients of the op route, ``bn_train_fused_bwd_plain``: ``bn_train_fused``
calls the custom ops ``rdt::bn_stats`` and ``rdt::bn_norm``, whose CPU
implementations are the plain versions and whose registered backward is
the same on the card.  Layouts: JAX [G, B, H, W, C], port [G, B, C, H, W].

Tolerances (tests/test_pallas.py:136-158), with the worst errors measured
on a CPU over every case here:
- f32: mean atol 1e-5 (measured 1.9e-6), var rtol 1e-4 / atol 1e-5
  (1.1e-5 absolute on variances of about 4), y atol 2e-4 (4.3e-6),
  gradients rtol 2e-3 / atol 2e-3 (dx 1.7e-6; dscale 4.2e-4 and dbias
  7.8e-4 absolute on sums of up to 28,800 terms of about 170).  Against the
  Pallas kernels in interpret mode: mean 2.4e-7, var 1.9e-6, y 1.4e-6.
- bf16 x: mean and var as f32 (both sides sum the same bf16 values in f32;
  measured 4.8e-7 and 5.9e-5); y and dx are rounded once to bf16 from f32
  values that differ in their last bits, so they are held to one bf16 ulp,
  rtol 2^-7, plus atol 1e-5 for values near 0, whose f32 error follows the
  terms that cancel there, not the result: in y the mean's summation error
  times the scale, in dx = rstd (dxhat - m1 - xhat m2) the sums m1, m2
  (measured: at most one ulp, except 13 of 184,320 values of y and 3 of
  230,400 values of dx, all within 3.9e-6); dscale and dbias as f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from representation_disentanglement_tpu.models import layers as jlayers
from representation_disentanglement_tpu.ops import pallas_bn
from representation_disentanglement_torch.models.layers import BatchNormTorch
from representation_disentanglement_torch.ops import fused_bn, kernels

B, C = 3, 8
EPS = 1e-5
TOL = {"mean": dict(rtol=0, atol=1e-5), "var": dict(rtol=1e-4, atol=1e-5),
       "y": dict(rtol=0, atol=2e-4), "grad": dict(rtol=2e-3, atol=2e-3)}
BF16_ROUNDED = dict(rtol=2.0 ** -7, atol=1e-5)


def _inputs(g, h, w, seed=0):
    """x [G, B, H, W, C] with per-channel offsets (the one-pass variance
    subtracts them), scale, bias [C], cotangent gy of y."""
    rs = np.random.default_rng(seed)
    x = (rs.normal(size=(g, B, h, w, C)) * 2.0 + 0.5
         + rs.normal(size=(C,))).astype(np.float32)
    scale = rs.normal(size=(C,)).astype(np.float32)
    bias = rs.normal(size=(C,)).astype(np.float32)
    gy = rs.normal(size=(g, B, h, w, C)).astype(np.float32)
    return x, scale, bias, gy


def _jax(x, scale, bias, gy, dtype):
    """(y, mean, var, dx, dscale, dbias) of the JAX fused pass, as f32
    numpy; x and gy in ``dtype``, y and dx in the port's layout."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj, gyj = jnp.asarray(x, jd), jnp.asarray(gy, jd)
    (y, mean, var), vjp = jax.vjp(
        lambda a, s, b: pallas_bn.bn_train_fused(a, s, b, EPS), xj,
        jnp.asarray(scale), jnp.asarray(bias))
    dx, ds, db = vjp((gyj, jnp.zeros_like(mean), jnp.zeros_like(var)))
    to_port = lambda a: np.asarray(a.astype(jnp.float32)).transpose(
        0, 1, 4, 2, 3)
    assert y.dtype == dx.dtype == jd
    return (to_port(y), np.asarray(mean), np.asarray(var), to_port(dx),
            np.asarray(ds), np.asarray(db))


def _port_tensors(x, scale, bias, gy, dtype, pdtype=torch.float32):
    t = lambda a: torch.from_numpy(a.transpose(0, 1, 4, 2, 3).copy()).to(
        dtype)
    xt = t(x).requires_grad_(True)
    st = torch.from_numpy(scale).to(pdtype).requires_grad_(True)
    bt = torch.from_numpy(bias).to(pdtype).requires_grad_(True)
    return xt, st, bt, t(gy)


def _np(t):
    return t.detach().float().numpy()


def _compare(got, want, dtype):
    """got, want: (y, mean, var, dx, dscale, dbias)."""
    names = ("y", "mean", "var", "dx", "dscale", "dbias")
    for name, a, b in zip(names, got, want):
        if dtype == torch.bfloat16 and name in ("y", "dx"):
            tol = BF16_ROUNDED
        else:
            tol = TOL.get(name, TOL["grad"])
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4, 5])
@pytest.mark.parametrize("hw", [(5, 6), (40, 48)])
def test_plain_fused_bn_matches_jax(dtype, g, hw):
    """Forward and all three gradients: autograd of the plain forward, and
    the plain backward the CUDA route uses."""
    x, scale, bias, gy = _inputs(g, *hw)
    want = _jax(x, scale, bias, gy, dtype)
    xt, st, bt, gyt = _port_tensors(x, scale, bias, gy, dtype)
    y, mean, var = fused_bn.bn_train_fused_plain(xt, st, bt, EPS)
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    assert tuple(mean.shape) == tuple(var.shape) == (g, C)
    dx, ds, db = torch.autograd.grad(y, (xt, st, bt), gyt)
    _compare([_np(t) for t in (y, mean, var, dx, ds, db)], want, dtype)
    bwd = fused_bn.bn_train_fused_bwd_plain(xt.detach(), st.detach(), mean,
                                            var, gyt, EPS)
    assert [t.dtype for t in bwd] == [dtype, torch.float32, torch.float32]
    _compare([_np(t) for t in (y, mean, var, *bwd)], want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_fused_bn_matches_pallas_kernels_interpreted(monkeypatch,
                                                           dtype):
    """The JAX forward through the Pallas kernels K6 + K7 (interpret mode,
    read at call time by pallas_bn.py:88 and :131)."""
    monkeypatch.setattr(pallas_bn, "_FORCE_INTERPRET", True)
    x, scale, bias, gy = _inputs(4, 40, 48, seed=1)
    assert pallas_bn.bn_train_fused_available(jnp.asarray(x))
    want = _jax(x, scale, bias, gy, dtype)
    xt, st, bt, gyt = _port_tensors(x, scale, bias, gy, dtype)
    y, mean, var = fused_bn.bn_train_fused_plain(xt, st, bt, EPS)
    dx, ds, db = torch.autograd.grad(y, (xt, st, bt), gyt)
    _compare([_np(t) for t in (y, mean, var, dx, ds, db)], want, dtype)


@pytest.fixture
def plain_launchers(monkeypatch):
    """Counts the calls of the ops' CPU implementations (the plain
    versions, looked up when called): the op route on the CPU."""
    calls = {"stats": 0, "norm": 0}
    real = fused_bn.bn_stats_plain, fused_bn.bn_norm_plain

    def stats(x):
        calls["stats"] += 1
        return real[0](x)

    def norm(x, mean, var, scale, bias, eps=EPS):
        calls["norm"] += 1
        return real[1](x, mean, var, scale, bias, eps)

    monkeypatch.setattr(fused_bn, "bn_stats_plain", stats)
    monkeypatch.setattr(fused_bn, "bn_norm_plain", norm)
    return calls


@pytest.mark.parametrize("dtype,pdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
def test_autograd_function_matches_jax(plain_launchers, dtype, pdtype):
    """``bn_train_fused`` through ``rdt::bn_stats`` and ``rdt::bn_norm``:
    one call of each op, mean and var without a gradient, dx in x's dtype,
    dscale and dbias in scale's (the op's registered backward), and the
    values of the JAX custom VJP."""
    x, scale, bias, gy = _inputs(4, 10, 12, seed=2)
    if pdtype == torch.bfloat16:        # both sides see the rounded affine
        scale, bias = (np.asarray(torch.from_numpy(a).bfloat16().float())
                       for a in (scale, bias))
    want = _jax(x, scale, bias, gy, dtype)
    xt, st, bt, gyt = _port_tensors(x, scale, bias, gy, dtype, pdtype)
    y, mean, var = fused_bn.bn_train_fused(
        xt.reshape((-1,) + tuple(xt.shape[2:])), st, bt, EPS,
        groups=xt.shape[0])
    y = y.reshape(xt.shape)
    assert plain_launchers == {"stats": 1, "norm": 1}
    assert not mean.requires_grad and not var.requires_grad
    dx, ds, db = torch.autograd.grad(y, (xt, st, bt), gyt)
    assert (dx.dtype, ds.dtype, db.dtype) == (dtype, pdtype, pdtype)
    got = [_np(t) for t in (y, mean, var, dx, ds, db)]
    if pdtype == torch.bfloat16:        # dscale, dbias rounded to bf16
        for k in (4, 5):
            np.testing.assert_allclose(got[k], want[k], **BF16_ROUNDED)
        got, want = got[:4], want[:4]
    _compare(got, want, dtype)


def test_cpu_dispatch_takes_the_plain_version():
    """``bn_train_fused`` on a CPU tensor: the plain version, no launch, no
    build; [G*B, C, H, W] in and out."""
    x, scale, bias, _ = _inputs(4, 5, 6)
    xt = torch.from_numpy(x.transpose(0, 1, 4, 2, 3).reshape(
        4 * B, C, 5, 6).copy())
    before = kernels.launch_counts()
    y, mean, var = fused_bn.bn_train_fused(
        xt, torch.from_numpy(scale), torch.from_numpy(bias), EPS, groups=4)
    assert kernels.launch_counts() == before
    assert kernels.BN_LIBRARY._lib is None
    assert tuple(y.shape) == tuple(xt.shape) and tuple(mean.shape) == (4, C)
    want = fused_bn.bn_train_fused_plain(
        xt.view(4, B, C, 5, 6), torch.from_numpy(scale),
        torch.from_numpy(bias), EPS)
    assert torch.equal(y, want[0].reshape(xt.shape))
    assert torch.equal(mean, want[1]) and torch.equal(var, want[2])


def test_launchers_refuse_what_the_kernels_do_not_take():
    """A CPU tensor or a wrong rank raises; nothing falls back or builds."""
    x = torch.zeros(2, 3, 4, 5, 6)
    m, v = torch.zeros(2, 4), torch.ones(2, 4)
    s, b = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fused_bn.bn_stats_cuda(x)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fused_bn.bn_norm_cuda(x, m, v, s, b)
    with pytest.raises(ValueError, match=r"\[G, B, C, H, W\]"):
        fused_bn.bn_stats_cuda(x[0])
    with pytest.raises(ValueError, match=r"\[G, B, C, H, W\]"):
        fused_bn.bn_norm_cuda(x[:, :0], m, v, s, b)
    assert kernels.BN_LIBRARY._lib is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_batchnorm_layer_matches_jax(monkeypatch, dtype):
    """``BatchNormTorch`` with ``fused`` on G=4 groups against JAX's
    ``BatchNormTorch`` with the fused pass on (``_BN_FUSED_DEFAULT``, read
    at trace time; ``_FORCE_INTERPRET`` so that the Pallas kernels run):
    y and the G ordered EMA updates of the running statistics, whose
    variance is var * n / (n - 1)."""
    monkeypatch.setattr(jlayers, "_BN_FUSED_DEFAULT", True)
    monkeypatch.setattr(pallas_bn, "_FORCE_INTERPRET", True)
    g, h, w = 4, 10, 12
    x, scale, bias, _ = _inputs(g, h, w, seed=3)
    rs = np.random.default_rng(4)
    ra_mean = rs.normal(0.0, 0.1, C).astype(np.float32)
    ra_var = rs.uniform(0.5, 1.5, C).astype(np.float32)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jbn = jlayers.BatchNormTorch(C)
    jv = {"params": {"scale": scale, "bias": bias},
          "batch_stats": {"mean": ra_mean, "var": ra_var}}
    want, muts = jax.jit(lambda v, a: jbn.apply(
        v, a, use_running_average=False, mutable=["batch_stats"]))(
        jv, jnp.asarray(x, jd))
    bn = BatchNormTorch(C).train()
    bn.fused = True
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
        bn.running_var.copy_(torch.from_numpy(ra_var))
    xt = torch.from_numpy(x.transpose(0, 1, 4, 2, 3).reshape(
        g * B, C, h, w).copy()).to(dtype)
    with torch.no_grad():
        y = bn(xt, groups=g)
    got = _np(y).reshape(g, B, C, h, w)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 1, 4, 2, 3)
    np.testing.assert_allclose(
        got, want, **(BF16_ROUNDED if dtype == torch.bfloat16 else TOL["y"]))
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(_np(getattr(bn, name)),
                                   np.asarray(muts["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# x [G, B, C, H, W] of every BatchNorm call of the flagship train step (the
# anatomy U-Net at G=4, the y decoder at G=5), the discriminator's (G=2),
# edge cases: H*W of 1, 30 and 7, G*C = 1, B = 1, a slab of 64 samples in
# two channels (a grid of two blocks), and the per-modality anatomy
# encoders' (G=1; the 'U+SA+CA' / 'U+SSA+CA' gates' are the 'U+SA' gates'
# shapes)
PLAN_SHAPES = [(4, 16, 64, 40, 48), (4, 16, 128, 20, 24), (4, 16, 256, 10, 12),
               (4, 16, 256, 5, 6), (4, 16, 32, 80, 96), (5, 16, 64, 80, 96),
               (5, 16, 128, 40, 48), (5, 16, 256, 20, 24),
               (5, 16, 512, 10, 12), (5, 16, 512, 5, 6), (2, 16, 32, 40, 48),
               (2, 16, 64, 20, 24), (2, 16, 128, 10, 12), (2, 16, 64, 5, 6),
               (3, 4, 300, 1, 1), (2, 3, 5, 5, 6), (2, 3, 37, 7, 1),
               (1, 6, 1, 9, 8), (4, 1, 8, 80, 96), (1, 64, 2, 80, 96),
               (1, 16, 64, 40, 48), (1, 16, 128, 20, 24),
               (1, 16, 256, 10, 12), (1, 16, 256, 5, 6)]


def _plan_counts(plan, shape):
    """How often K6's threads under ``plan`` read each vector of x, and how
    often each (group, channel) is written, following bn_train.cu's index
    arithmetic: block (tile, group), thread (lane, channel, stream), stream
    s taking rows s, s + streams, ..."""
    g, b, c, h, w = shape
    nv = h * w // plan.vec
    tiles, chunks, rows = plan.geometry(shape)
    blk = np.arange(plan.blocks(shape), dtype=np.int64)[:, None, None]
    t = np.arange(plan.threads, dtype=np.int64)[None, :, None]
    per = plan.ct * plan.vt
    stream, cl, lane = t // per, t % per // plan.vt, t % plan.vt
    k = np.arange(-(-rows // plan.streams), dtype=np.int64)[None, None, :]
    r = stream + k * plan.streams
    gi, tile = blk // tiles, blk % tiles
    ch = tile * plan.ct + cl
    active = (stream < plan.streams) & (ch < c)
    bi, v = r // chunks, (r % chunks) * plan.vt + lane
    ok = active & (r < rows) & (v < nv)
    vec_index = ((gi * b + bi) * c + ch) * nv + v
    reads = np.bincount(vec_index[ok], minlength=g * b * c * nv)
    head = (active & (lane == 0) & (stream == 0))[:, :, 0]
    writes = np.bincount(((gi * c + ch)[:, :, 0])[head], minlength=g * c)
    return reads, writes


def _norm_counts(shape, vec):
    """How often K7's threads read each vector of x, and in how many
    planes each thread's vector lies: thread t of block k takes the vec
    values from (k * NORM_THREADS + t) * vec of the flat x."""
    g, b, c, h, w = shape
    total = g * b * c * h * w
    blocks = fused_bn.bn_norm_blocks(shape, vec)
    i = np.arange(blocks * fused_bn.NORM_THREADS, dtype=np.int64) * vec
    i = i[i < total]
    reads = np.bincount(i // vec, minlength=total // vec)
    planes = (i + vec - 1) // (h * w) - i // (h * w) + 1
    return reads, planes


# aligned in bf16 and f32 at every shape; misaligned x (bf16 at a 2-byte,
# f32 at an 8-byte offset) at the shapes below 2 M values
PLAN_CASES = [(shape, esize, align) for shape in PLAN_SHAPES
              for esize, align in ((2, 16), (4, 16), (2, 2), (4, 8))
              if align == 16 or int(np.prod(shape)) <= 2_000_000]


@pytest.mark.parametrize("kernel", ["stats", "norm"])
@pytest.mark.parametrize("shape,esize,align", PLAN_CASES)
def test_bn_plan_covers_every_value_once(kernel, shape, esize, align):
    """K6's launch plan (``fused_bn.bn_plan``) and K7's grid at every
    BatchNorm shape of the train step and the edge cases, in bf16 and f32,
    at 16-byte and smaller pointer alignment, on 132 SMs: a load is at most
    16 bytes and divides H*W and the alignment; every vector of x is read
    by exactly one thread; K6 writes each (group, channel) once (lane 0 of
    the channel's first stream) from blocks of whole warps of at most 512
    threads; each of K7's vectors lies in one plane."""
    g, b, c, h, w = shape
    vec = fused_bn.bn_vec(h * w, esize, align)
    assert vec * esize <= 16 and (h * w) % vec == 0
    assert align % (vec * esize) == 0
    if kernel == "norm":
        reads, planes = _norm_counts(shape, vec)
        assert reads.min() == reads.max() == 1
        assert planes.max() == 1
        return
    plan = fused_bn.bn_plan(shape, esize, align, 132)
    assert plan.vec == vec
    assert plan.threads % 32 == 0 and plan.threads <= fused_bn.MAX_THREADS
    assert plan.vt * plan.ct * plan.streams == plan.threads
    # shuffles within a channel's lanes
    assert (plan.vt & (plan.vt - 1) == 0) if plan.vt <= 32 else (
        plan.vt % 32 == 0)
    reads, writes = _plan_counts(plan, shape)
    assert reads.min() == reads.max() == 1
    assert writes.min() == writes.max() == 1


def test_bn_plan_at_the_flagship_shapes():
    """At every BatchNorm shape of the flagship step (bf16, 16-byte
    aligned, 132 SMs): 16-byte loads wherever H*W is a multiple of 8 (all
    but 5x6, which loads 4 bytes); K6's grid holds at least half as many
    blocks as SMs, K7's a wave at least."""
    for shape in PLAN_SHAPES[:10]:
        plan = fused_bn.bn_plan(shape, 2, 16, 132)
        vec = 8 if shape[3:] != (5, 6) else 2
        assert plan.vec == fused_bn.bn_vec(shape[3] * shape[4], 2, 16) == vec
        assert plan.blocks(shape) >= 66, (shape, plan)
        assert fused_bn.bn_norm_blocks(shape, vec) >= 132


@pytest.mark.parametrize("hw,esize,align,vec", [
    (7680, 2, 16, 8), (7680, 4, 16, 4), (30, 2, 16, 2), (30, 4, 16, 2),
    (7, 2, 16, 1), (1, 4, 16, 1), (7680, 2, 2, 1), (7680, 4, 8, 2),
    (120, 2, 8, 4), (36, 2, 16, 4)])
def test_bn_vec_widest_load(hw, esize, align, vec):
    """The load width of K6 and K7: the widest power of two of values, at
    most 16 bytes, that divides H*W and the pointers' alignment."""
    assert fused_bn.bn_vec(hw, esize, align) == vec
