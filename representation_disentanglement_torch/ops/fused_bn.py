"""Fused BatchNorm training pass: the counterpart of the JAX package's
``ops/pallas_bn.py``.

BatchNorm in train mode over grouped activations x [G, B, C, H, W] (G
groups of B samples, NCHW; the JAX layout is [G, B, H, W, C]): per (group,
channel) the f32 mean and the biased one-pass variance E[x^2] - mean^2 over
(B, H, W), then y = (x - mean) * (rsqrt(var + eps) * scale) + bias in f32,
rounded once to x's dtype.

On a CUDA tensor two hand-written kernels of ``csrc/bn_train.cu`` run it:
``rdt_bn_stats`` (K6, replaces the Pallas ``_stats_kernel``,
pallas_bn.py:46) and ``rdt_bn_norm`` (K7, replaces ``_norm_kernel``,
pallas_bn.py:69).  The backward is plain PyTorch, as the JAX package's is
plain XLA (pallas_bn.py:142-169).  The TPU kernels fell back to XLA where a
block did not fit VMEM (pallas_bn.py:78-88); these kernels take every
shape, so there is no such route here.

Both kernels load ``bn_vec`` values at a time: 16 bytes where H*W and the
pointers allow it, else the widest vector that divides both.  K6 runs under
a plan that ``bn_plan`` chooses per shape, dtype, pointer alignment and SM
count (cached): a tile of channels per block with a fixed channel per
thread, and the (sample, chunk) rows of a tile dealt to the streams of the
block.  K7 is elementwise, one thread per vector.  The source note of
bn_train.cu gives the design; tests/test_torch_fused_bn.py checks on the
CPU that K6's plan and K7's grid cover every value exactly once.

Binding: the kernels are the torch custom ops ``rdt::bn_stats`` (x ->
mean, var) and ``rdt::bn_norm`` (x, mean, var, scale, bias, eps -> y).
Each op's CUDA implementation is the ctypes launch (``bn_stats_cuda``,
``bn_norm_cuda``, looked up when called), its CPU implementation the plain
version, and a fake implementation gives the tracer mean and var f32
[G, C] and y of x's shape and dtype.  ``bn_train_fused`` calls
``rdt::bn_stats`` on x without a gradient, then ``rdt::bn_norm``, whose
backward (``register_autograd``) is ``bn_train_fused_bwd_plain`` on every
device: the VJP of the whole fused pass, the path through the statistics
included, as the JAX package's custom VJP; the caller's statistics are
those of the same x.  The launchers raise on anything the kernels do not
take; nothing gives way to the plain version.  Both read the stream handle
with one C call.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from representation_disentanglement_torch.ops import kernels

_DTYPES = (torch.float32, torch.bfloat16)
_RED = (1, 3, 4)                      # (B, H, W) of [G, B, C, H, W]


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    """[G, C] -> [G, 1, C, 1, 1]; [C] -> [1, 1, C, 1, 1]."""
    return t.reshape(-1, 1, t.shape[-1], 1, 1)


def bn_stats_plain(x: torch.Tensor):
    """(mean, var) [G, C] f32 of x [G, B, C, H, W]: the f32 mean and the
    biased one-pass variance (pallas_bn.py:116-119)."""
    x32 = x.float()
    mean = x32.mean(dim=_RED)
    var = x32.square().mean(dim=_RED) - mean.square()
    return mean, var


def bn_norm_plain(x, mean, var, scale, bias, eps: float = 1e-5):
    """(x - mean) * (rsqrt(var + eps) * scale) + bias in f32, rounded once
    to x's dtype (pallas_bn.py:69-75)."""
    a = torch.rsqrt(var.float() + eps) * scale.float()
    y = (x.float() - _per_channel(mean.float())) * _per_channel(a) \
        + _per_channel(bias.float())
    return y.to(x.dtype)


def bn_train_fused_plain(x, scale, bias, eps: float = 1e-5):
    """x [G, B, C, H, W] -> (y of x's shape and dtype, mean [G, C] f32,
    var [G, C] f32 biased).  x is cast to f32 once, so that autograd sums
    the gradient of x's three uses in f32 before its one rounding."""
    x32 = x.float()
    mean, var = bn_stats_plain(x32)
    y = bn_norm_plain(x32, mean, var, scale, bias, eps)
    return y.to(x.dtype), mean, var


def bn_train_fused_bwd_plain(x, scale, mean, var, gy, eps: float = 1e-5,
                             axis=None):
    """The VJP of ``bn_train_fused`` for the cotangent gy of y, from the
    residuals of the forward (pallas_bn.py:142-169, without the cotangents
    of mean and var, which the caller never differentiates):
    xhat = (x - mean) rstd, dxhat = gy scale,
    dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
    dscale = sum(gy xhat), dbias = sum(gy).
    Returns dx in x's dtype, dscale and dbias in scale's.  With a data
    ``axis`` (synchronized BatchNorm, statistics of the global batch) the
    two means are over the global batch, all-reduced; dscale and dbias
    stay the rank's sums (the step all-reduces the gradients)."""
    x32, gy32 = x.float(), gy.float()
    rstd = _per_channel(torch.rsqrt(var.float() + eps))
    xhat = (x32 - _per_channel(mean.float())) * rstd
    dxhat = gy32 * _per_channel(scale.float())
    m1 = dxhat.mean(dim=_RED, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=_RED, keepdim=True)
    if axis is not None:
        both = torch.stack([m1, m2])
        torch.distributed.all_reduce(both, group=axis.group)
        m1, m2 = both[0] / axis.size, both[1] / axis.size
    dx = rstd * (dxhat - m1 - xhat * m2)
    dscale = (gy32 * xhat).sum(dim=(0,) + _RED)
    dbias = gy32.sum(dim=(0,) + _RED)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


MAX_THREADS = 512          # threads per block (bn_train.cu's kMaxThreads)
MAX_VT = 256               # K6's vector lanes of a channel in a block
NORM_THREADS = 256         # K7's block (bn_train.cu's kNormThreads)


def bn_vec(hw: int, esize: int, align: int) -> int:
    """Values per load of K6 and K7 at planes of ``hw`` values of ``esize``
    bytes and pointers aligned to ``align`` bytes: the widest power of two
    of at most 16 bytes that divides both, so that no vector crosses a
    plane."""
    return next(v for v in (8, 4, 2, 1) if v * esize <= 16 and hw % v == 0
                and align % (v * esize) == 0)


def bn_norm_blocks(shape, vec: int) -> int:
    """K7's grid at x of ``shape``: one thread per vector, NORM_THREADS a
    block."""
    return -(-math.prod(shape) // vec // NORM_THREADS)


class BNPlan(NamedTuple):
    """How K6 maps x [G, B, C, H, W] onto blocks and threads.

    vec: values per load (``bn_vec``); a plane holds V = H*W / vec vectors,
    cut into ``chunks`` chunks of at most vt vectors (vt a power of two up
    to 32 or a multiple of 32, for the shuffles).  A block is (vt, ct,
    streams) threads, ``threads`` in all: a vector lane, a channel of the
    block's tile of ct channels of one group, a stream.  The rows of a tile
    are its B * chunks (sample, chunk) pairs; stream s takes row s, then
    every streams-th."""
    vec: int
    vt: int
    ct: int
    streams: int
    threads: int

    def geometry(self, shape):
        """(tiles per group, chunks per plane, rows per tile)."""
        _, b, c, h, w = shape
        chunks = -(-(h * w // self.vec) // self.vt)
        return -(-c // self.ct), chunks, b * chunks

    def blocks(self, shape) -> int:
        return shape[0] * self.geometry(shape)[0]


@functools.lru_cache(maxsize=1024)
def bn_plan(shape, esize: int, align: int, sm_count: int) -> BNPlan:
    """K6's plan at x of ``shape`` [G, B, C, H, W] with ``esize`` bytes per
    value, x aligned to ``align`` bytes, on a card of ``sm_count`` SMs.

    The rules came from trying plans on the H100 (PERF.md gives the times
    that chip_smoke.py measures under them): blocks of one channel where a
    chunk has 128 lanes or more (two streams where the tiles are fewer than
    the SMs), else blocks of 128 threads with as many channels as still
    leave about two blocks per SM and the rest in streams."""
    g, b, c, h, w = shape
    hw = h * w
    vec = bn_vec(hw, esize, align)
    nv = hw // vec
    chunks = -(-nv // MAX_VT)
    per = -(-nv // chunks)                    # balanced chunks
    rows = b * chunks
    # a power of two up to 32, else whole warps: the lanes of a channel
    # reduce by shuffles within a warp
    vt = 1 << (per - 1).bit_length() if per <= 32 else -(-per // 32) * 32
    if vt >= 128:
        # one channel a block; two streams where the tiles are fewer than
        # the SMs
        ct = 1
        streams = 2 if g * c < sm_count else 1
    else:
        # 128 threads, with as many channels as leave about two blocks per
        # SM
        ct = 1
        while ct * 2 * vt <= 64 and g * c >= 2 * ct * 2 * sm_count:
            ct *= 2
        # whole warps: a power of two of streams, no more than the rows
        # need beyond that
        streams = max(32 // (vt * ct),
                      min(128 // (vt * ct), 1 << (rows - 1).bit_length()))
    return BNPlan(vec, vt, ct, streams, vt * ct * streams)


def _align(*ptrs) -> int:
    """The largest power of two up to 16 that divides every pointer."""
    a = 16
    for p in ptrs:
        a = min(a, p & -p) if p else a
    return a


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(x) -> int:
    """The handle of the current stream on x's device, in one call."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(x.device.index)
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(fn: str, name: str, t, device, shape, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} is on {t.device}, not a CUDA device")
    if t.device != device:
        raise ValueError(f"{fn}: inputs on different devices")
    if t.shape != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}; need "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")
    if t.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} is {t.dtype}; the kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)}")


def _check_x(fn: str, x) -> None:
    if x.dim() != 5 or x.numel() == 0:
        raise ValueError(f"{fn}: x has shape {tuple(x.shape)}; need a "
                         "non-empty [G, B, C, H, W]")
    _check(fn, "x", x, x.device, x.shape, _DTYPES)


def bn_stats_cuda(x):
    """Launch K6 on a contiguous CUDA x [G, B, C, H, W] (f32 or bf16):
    returns (mean, var) [G, C] f32."""
    _check_x("bn_stats_cuda", x)
    g, b, c, h, w = shape = x.shape
    xp = x.data_ptr()
    plan = bn_plan(shape, x.element_size(), _align(xp),
                   _sm_count(x.device.index))
    mean = torch.empty((g, c), device=x.device, dtype=torch.float32)
    var = torch.empty_like(mean)
    kernels.BN_STATS.launch(
        xp, mean.data_ptr(), var.data_ptr(), g, b, c, h * w,
        int(x.dtype == torch.bfloat16), *plan, x.device.index, _stream(x),
        shape=shape)
    return mean, var


def bn_norm_cuda(x, mean, var, scale, bias, eps: float = 1e-5):
    """Launch K7 on a contiguous CUDA x [G, B, C, H, W] with mean, var
    [G, C] f32 and scale, bias [C] of one dtype (f32 or bf16): returns y of
    x's shape and dtype."""
    _check_x("bn_norm_cuda", x)
    shape = x.shape
    for name, t in (("mean", mean), ("var", var)):
        _check("bn_norm_cuda", name, t, x.device, (shape[0], shape[2]),
               (torch.float32,))
    for name, t in (("scale", scale), ("bias", bias)):
        _check("bn_norm_cuda", name, t, x.device, (shape[2],), _DTYPES)
    if scale.dtype != bias.dtype:
        raise TypeError("bn_norm_cuda: scale and bias differ in dtype")
    g, b, c, h, w = shape
    y = torch.empty_like(x)
    xp, yp = x.data_ptr(), y.data_ptr()
    kernels.BN_NORM.launch(
        xp, mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), yp, g, b, c, h * w, int(x.dtype == torch.bfloat16),
        int(scale.dtype == torch.bfloat16), float(eps),
        bn_vec(h * w, x.element_size(), _align(xp, yp)), x.device.index,
        _stream(x), shape=shape)
    return y


@torch.library.custom_op("rdt::bn_stats", mutates_args=(),
                         device_types="cuda")
def _bn_stats_op(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return bn_stats_cuda(x)


@_bn_stats_op.register_kernel("cpu")
def _(x):
    return bn_stats_plain(x)


@_bn_stats_op.register_fake
def _(x):
    mean = x.new_empty((x.shape[0], x.shape[2]), dtype=torch.float32)
    return mean, torch.empty_like(mean)


@torch.library.custom_op("rdt::bn_norm", mutates_args=(),
                         device_types="cuda")
def _bn_norm_op(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    return bn_norm_cuda(x, mean, var, scale, bias, eps)


@_bn_norm_op.register_kernel("cpu")
def _(x, mean, var, scale, bias, eps):
    return bn_norm_plain(x, mean, var, scale, bias, eps)


@_bn_norm_op.register_fake
def _(x, mean, var, scale, bias, eps):
    return torch.empty_like(x)


def _bn_norm_setup(ctx, inputs, output):
    x, mean, var, scale, _, eps = inputs
    ctx.save_for_backward(x, scale, mean, var)   # pallas_bn.py:139
    ctx.eps = eps


def _bn_norm_backward(ctx, gy):
    x, scale, mean, var = ctx.saved_tensors
    dx, dscale, dbias = bn_train_fused_bwd_plain(x, scale, mean, var, gy,
                                                 ctx.eps)
    return dx, None, None, dscale, dbias, None


_bn_norm_op.register_autograd(_bn_norm_backward,
                              setup_context=_bn_norm_setup)


def combine_stats(mean, var, axis):
    """The global batch's (mean, biased var) [G, C] from each rank's, in
    f32: the mean of the means and the mean of var_r + (m_r - m)^2 (equal
    counts on every rank), from one all-gather."""
    both = torch.stack([mean.float(), var.float()])
    parts = [torch.empty_like(both) for _ in range(axis.size)]
    torch.distributed.all_gather(parts, both, group=axis.group)
    allp = torch.stack(parts)                       # [N, 2, G, C]
    m = allp[:, 0].mean(0)
    v = (allp[:, 1] + (allp[:, 0] - m).square()).mean(0)
    return m, v


class _SyncBNNorm(torch.autograd.Function):
    """K7 with the global statistics; backward the synchronized VJP."""

    @staticmethod
    def forward(ctx, xg, mean, var, scale, bias, eps, axis):
        ctx.save_for_backward(xg, scale, mean, var)
        ctx.eps, ctx.axis = eps, axis
        return torch.ops.rdt.bn_norm(xg, mean, var, scale, bias, eps)

    @staticmethod
    def backward(ctx, gy):
        x, scale, mean, var = ctx.saved_tensors
        dx, dscale, dbias = bn_train_fused_bwd_plain(
            x, scale, mean, var, gy, ctx.eps, ctx.axis)
        return dx, None, None, dscale, dbias, None, None


def bn_train_fused(x, scale, bias, eps: float = 1e-5, groups: int = 1,
                   axis=None):
    """Train-mode BatchNorm of x [G*B, C, H, W] (group-major) with each of
    the ``groups`` groups normalized by its own batch statistics.  Returns
    (y [G*B, C, H, W] in x's dtype, mean [G, C] f32, var [G, C] f32
    biased); mean and var carry no gradient (the JAX caller stop-gradients
    them, models/layers.py:254-255).  Through ``rdt::bn_stats`` and
    ``rdt::bn_norm``: the plain versions for a CPU tensor, the CUDA kernels
    for a CUDA tensor.

    With a data ``axis`` (synchronized BatchNorm): K6 on the rank's rows,
    ``combine_stats`` over the ranks, K7 with the global statistics, and
    the backward's two channel means all-reduced."""
    xg = x.reshape((groups, -1) + tuple(x.shape[1:])).contiguous()
    mean, var = torch.ops.rdt.bn_stats(xg.detach())
    if axis is not None:
        mean, var = combine_stats(mean, var, axis)
        y = _SyncBNNorm.apply(xg, mean, var, scale, bias, float(eps), axis)
        return y.reshape(x.shape), mean, var
    y = torch.ops.rdt.bn_norm(xg, mean, var, scale, bias, float(eps))
    return y.reshape(x.shape), mean, var
