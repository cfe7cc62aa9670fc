"""3D convolution primitives and group norm for the volumetric stack (JAX
``ops/conv3d.py``).

Layout is the reference's, ``[B, C, H, W, D]`` (src/model.py:1856-2060
runs nn.Conv3d on it), with kernels ``(O, I, kH, kW, kD)``; the JAX
package's ``[B, D, H, W, C]`` is a transpose of it.  Everything here maps
to one PyTorch/cuDNN op.

Inside a ``depth_sharded(axis)`` scope (parallel/halo.py: the volume's
depth, the last dim, split over the ranks of ``axis``) the same model code
runs on a depth block: ``conv3d`` takes its depth padding from a one-hop
halo exchange with the neighbouring ranks (``halo_exchange``; zeros at the
volume's ends, exact for kd = 2 * pad + 1), ``group_norm`` all-reduces its
(sum, sum of squares) and ``global_mean3d`` its mean, as JAX's
``ppermute``/``pmean`` variants do (JAX ops/conv3d.py:21-129).  Under a
``parallel.tp.channel_parallel`` scope ``conv3d`` computes a block of its
output channels and all-gathers them.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from representation_disentanglement_torch.parallel.mesh import (
    Axis, all_reduce_sum)

_DEPTH: contextvars.ContextVar[Optional[Axis]] = contextvars.ContextVar(
    "rdt_depth_axis", default=None)


@contextlib.contextmanager
def depth_sharded(axis: Axis):
    """The scope in which the 3D primitives run depth-sharded over
    ``axis``."""
    tok = _DEPTH.set(axis)
    try:
        yield
    finally:
        _DEPTH.reset(tok)


def current_depth_axis() -> Optional[Axis]:
    return _DEPTH.get()


def _swap(to_left: torch.Tensor, to_right: torch.Tensor, axis: Axis):
    """Send ``to_left`` to rank - 1 and ``to_right`` to rank + 1 of
    ``axis``; returns (from the left, from the right), zeros where there
    is no neighbour."""
    from_left = torch.zeros_like(to_right)
    from_right = torch.zeros_like(to_left)
    ops = []
    r = axis.rank
    if r > 0:
        ops += [dist.P2POp(dist.isend, to_left.contiguous(),
                           axis.ranks[r - 1], axis.group),
                dist.P2POp(dist.irecv, from_left, axis.ranks[r - 1],
                           axis.group)]
    if r < axis.size - 1:
        ops += [dist.P2POp(dist.isend, to_right.contiguous(),
                           axis.ranks[r + 1], axis.group),
                dist.P2POp(dist.irecv, from_right, axis.ranks[r + 1],
                           axis.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


class _Halo(torch.autograd.Function):
    """[..., D] -> [..., halo + D + halo]: the neighbours' edge slices on
    both sides of the last dim.  Backward sends the halos' gradients back
    to the ranks they came from, which add them to their edge slices."""

    @staticmethod
    def forward(ctx, x, halo: int, axis: Axis):
        ctx.halo, ctx.axis = halo, axis
        if axis.size == 1:
            z = x.new_zeros(x.shape[:-1] + (halo,))
            return torch.cat([z, x, z], -1)
        left, right = _swap(x[..., :halo], x[..., -halo:], axis)
        return torch.cat([left, x, right], -1)

    @staticmethod
    def backward(ctx, g):
        h, axis = ctx.halo, ctx.axis
        gx = g[..., h:-h].clone()
        if axis.size > 1:
            from_left, from_right = _swap(g[..., :h], g[..., -h:], axis)
            gx[..., :h] += from_left
            gx[..., -h:] += from_right
        return gx, None, None


def halo_exchange(x: torch.Tensor, halo: int, axis: Axis) -> torch.Tensor:
    """``halo`` depth slices of each neighbour on either side of x's last
    dim (zeros at the volume's ends), differentiable (JAX
    ``_halo_exchange_d``)."""
    return _Halo.apply(x, halo, axis)


def conv3d(x: torch.Tensor, w: torch.Tensor, b=None, stride=1,
           padding=1) -> torch.Tensor:
    """x: [B, Ci, H, W, D], w: [Co, Ci, kh, kw, kd], b: [Co] or None.

    Depth-sharded, the depth padding comes from ``halo_exchange`` and the
    convolution is VALID on D; stride 2 needs an even local depth."""
    from representation_disentanglement_torch.parallel.tp import (
        channel_block)
    axis = _DEPTH.get()
    if axis is not None and padding:
        assert w.shape[-1] == 2 * padding + 1, \
            "the halo path needs kd == 2 * padding + 1"
        x = halo_exchange(x, padding, axis)
        padding = (padding, padding, 0)
    w, b, gather = channel_block(w, b)
    y = F.conv3d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, padding=padding)
    return gather(y)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """nn.GroupNorm on [B, C, ...]: per (sample, group) over the spatial
    dims and the group's channels, in f32, then scale and bias, cast back.

    ``F.group_norm`` is one kernel forward and one backward, where the JAX
    package's one-pass form (``mean(x^2) - mean^2``) is five elementwise
    passes over a 126 MB activation at full width.  Its variance is
    Welford's, which agrees with the one-pass form within the tolerance of
    tests/test_torch_unet3d.py and loses nothing where mean^2 >> var.

    Depth-sharded, the statistics are global: the per-(sample, group) sum
    and sum of squares all-reduced over the depth axis, the variance
    one-pass, as JAX's sharded branch."""
    axis = _DEPTH.get()
    if axis is None:
        y = F.group_norm(x.float(), num_groups, scale.float(), bias.float(),
                         eps)
        return y.to(x.dtype)
    xg = x.float().reshape(x.shape[0], num_groups, -1)
    sums = all_reduce_sum(torch.stack([xg.sum(-1), xg.square().sum(-1)]),
                          axis)
    count = xg.shape[-1] * axis.size
    mean, msq = sums[0] / count, sums[1] / count
    rstd = torch.rsqrt(msq - mean.square() + eps)
    y = ((xg - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(shape) + bias.float().reshape(shape)
    return y.to(x.dtype)


def global_mean3d(x: torch.Tensor) -> torch.Tensor:
    """Mean over (H, W, D): [B, C, H, W, D] -> [B, C]
    (AdaptiveAvgPool3d(1), src/model.py:1893); depth-sharded, the mean of
    the ranks' means (equal blocks)."""
    m = x.mean(dim=(2, 3, 4))
    axis = _DEPTH.get()
    if axis is None:
        return m
    return all_reduce_sum(m, axis) / axis.size


def upsample3d_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """nn.Upsample(scale_factor=factor) (nearest) on [B, C, H, W, D]: each
    voxel repeated ``factor`` times along every spatial axis, as JAX's
    ``jnp.repeat`` (output index i reads input i // factor)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")
