"""Fused BatchNorm training pass: the counterpart of the JAX package's
``ops/pallas_bn.py``.

BatchNorm in train mode over grouped activations x [G, B, C, H, W] (G
groups of B samples, NCHW; the JAX layout is [G, B, H, W, C]): per (group,
channel) the f32 mean and the biased one-pass variance E[x^2] - mean^2 over
(B, H, W), then y = (x - mean) * (rsqrt(var + eps) * scale) + bias in f32,
rounded once to x's dtype.

On a CUDA tensor two hand-written kernels of ``csrc/bn_train.cu`` run it:
``rdt_bn_stats`` (replaces the Pallas ``_stats_kernel``, pallas_bn.py:46)
and ``rdt_bn_norm`` (replaces ``_norm_kernel``, pallas_bn.py:69).  The
backward is plain PyTorch, as the JAX package's is plain XLA
(pallas_bn.py:142-169).  The TPU kernels fell back to XLA where a block did
not fit VMEM (pallas_bn.py:78-88); these kernels take every shape, so there
is no such route here.

Dispatch: ``bn_train_fused`` takes the plain version for a tensor on the CPU
(autograd differentiates it there) and ``BNTrainFused`` for a CUDA tensor:
its forward launches the two kernels, its backward is
``bn_train_fused_bwd_plain``.  The launchers ``bn_stats_cuda`` and
``bn_norm_cuda`` raise on anything the kernels do not take; nothing gives
way to the plain version.
"""

from __future__ import annotations

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


def bn_train_fused_bwd_plain(x, scale, mean, var, gy, eps: float = 1e-5):
    """The VJP of ``bn_train_fused`` for the cotangent gy of y, from the
    residuals of the forward (pallas_bn.py:142-169, without the cotangents
    of mean and var, which the caller never differentiates):
    xhat = (x - mean) rstd, dxhat = gy scale,
    dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
    dscale = sum(gy xhat), dbias = sum(gy).
    Returns dx in x's dtype, dscale and dbias in scale's."""
    x32, gy32 = x.float(), gy.float()
    rstd = _per_channel(torch.rsqrt(var.float() + eps))
    xhat = (x32 - _per_channel(mean.float())) * rstd
    dxhat = gy32 * _per_channel(scale.float())
    m1 = dxhat.mean(dim=_RED, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=_RED, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    dscale = (gy32 * xhat).sum(dim=(0,) + _RED)
    dbias = gy32.sum(dim=(0,) + _RED)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


def _check(fn: str, name: str, t, device, shape, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} is on {t.device}, not a CUDA device")
    if t.device != device:
        raise ValueError(f"{fn}: inputs on different devices")
    if tuple(t.shape) != tuple(shape):
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
    g, b, c, h, w = x.shape
    mean = torch.empty((g, c), device=x.device, dtype=torch.float32)
    var = torch.empty_like(mean)
    kernels.BN_STATS.launch(
        x.data_ptr(), mean.data_ptr(), var.data_ptr(), g, b, c, h * w,
        int(x.dtype == torch.bfloat16), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream, shape=x.shape)
    return mean, var


def bn_norm_cuda(x, mean, var, scale, bias, eps: float = 1e-5):
    """Launch K7 on a contiguous CUDA x [G, B, C, H, W] with mean, var
    [G, C] f32 and scale, bias [C] of one dtype (f32 or bf16): returns y of
    x's shape and dtype."""
    _check_x("bn_norm_cuda", x)
    g, b, c, h, w = x.shape
    for name, t in (("mean", mean), ("var", var)):
        _check("bn_norm_cuda", name, t, x.device, (g, c), (torch.float32,))
    for name, t in (("scale", scale), ("bias", bias)):
        _check("bn_norm_cuda", name, t, x.device, (c,), _DTYPES)
    if scale.dtype != bias.dtype:
        raise TypeError("bn_norm_cuda: scale and bias differ in dtype")
    y = torch.empty_like(x)
    kernels.BN_NORM.launch(
        x.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), y.data_ptr(), g, b, c, h * w,
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        float(eps), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream, shape=x.shape)
    return y


class BNTrainFused(torch.autograd.Function):
    """K6 then K7 as one autograd node on x [G, B, C, H, W].  Saves x,
    scale, mean and var, the residuals of pallas_bn.py:139; mean and var
    are outputs without a gradient (the JAX caller stop-gradients them,
    models/layers.py:254-255)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, var = bn_stats_cuda(x)
        y = bn_norm_cuda(x, mean, var, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, mean, var = ctx.saved_tensors
        dx, dscale, dbias = bn_train_fused_bwd_plain(x, scale, mean, var, gy,
                                                     ctx.eps)
        return dx, dscale, dbias, None


def bn_train_fused(x, scale, bias, eps: float = 1e-5, groups: int = 1):
    """Train-mode BatchNorm of x [G*B, C, H, W] (group-major) with each of
    the ``groups`` groups normalized by its own batch statistics.  Returns
    (y [G*B, C, H, W] in x's dtype, mean [G, C] f32, var [G, C] f32
    biased); mean and var carry no gradient.  The plain version for a CPU
    tensor, the CUDA kernels for a CUDA tensor."""
    xg = x.reshape((groups, -1) + tuple(x.shape[1:]))
    if x.device.type == "cpu":
        y, mean, var = bn_train_fused_plain(xg, scale, bias, eps)
        mean, var = mean.detach(), var.detach()
    else:
        y, mean, var = BNTrainFused.apply(xg.contiguous(), scale, bias, eps)
    return y.reshape(x.shape), mean, var
