"""3D convolution primitives and group norm for the volumetric stack (JAX
``ops/conv3d.py``).

Layout is the reference's, ``[B, C, H, W, D]`` (src/model.py:1856-2060
runs nn.Conv3d on it), with kernels ``(O, I, kH, kW, kD)``; the JAX
package's ``[B, D, H, W, C]`` is a transpose of it.  Everything here maps
to one PyTorch/cuDNN op.  The depth-sharded variants of the JAX module
(halo exchange, psum'd statistics) are ROADMAP item 16 and not here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3d(x: torch.Tensor, w: torch.Tensor, b=None, stride=1,
           padding=1) -> torch.Tensor:
    """x: [B, Ci, H, W, D], w: [Co, Ci, kh, kw, kd], b: [Co] or None."""
    return F.conv3d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """nn.GroupNorm on [B, C, ...]: per (sample, group) over the spatial
    dims and the group's channels, in f32, then scale and bias, cast back.

    ``F.group_norm`` is one kernel forward and one backward, where the JAX
    package's one-pass form (``mean(x^2) - mean^2``) is five elementwise
    passes over a 126 MB activation at full width.  Its variance is
    Welford's, which agrees with the one-pass form within the tolerance of
    tests/test_torch_unet3d.py and loses nothing where mean^2 >> var."""
    y = F.group_norm(x.float(), num_groups, scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def global_mean3d(x: torch.Tensor) -> torch.Tensor:
    """Mean over (H, W, D): [B, C, H, W, D] -> [B, C]
    (AdaptiveAvgPool3d(1), src/model.py:1893)."""
    return x.mean(dim=(2, 3, 4))


def upsample3d_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """nn.Upsample(scale_factor=factor) (nearest) on [B, C, H, W, D]: each
    voxel repeated ``factor`` times along every spatial axis, as JAX's
    ``jnp.repeat`` (output index i reads input i // factor)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")
