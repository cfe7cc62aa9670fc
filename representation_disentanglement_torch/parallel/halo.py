"""Depth-sharded whole-volume 3D (JAX ``parallel/halo.py``): context
parallelism for volumes.

Each rank holds a block of every volume's depth (the last dim of the
port's [B, C, H, W, D]); inside ``ops.conv3d.depth_sharded`` the 3D
primitives exchange one-slice halos with the neighbouring ranks before
each depth-padded convolution and all-reduce GroupNorm's statistics and the
VAE's pooling, so the same model code computes the unsharded forward (up to
reduction order).  ``make_volume_mesh`` composes that with a data axis:
rank = row * n_depth + depth index, as JAX's ``devices.reshape(n_data,
n_depth)``; one process group per line of each axis.

Constraints, as JAX's: D and D / 16 divide by the depth shards (the VAE
decodes from D / 16), and the block's depth divides by 8 (three stride-2
stages).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from representation_disentanglement_torch.ops.conv3d import depth_sharded
from representation_disentanglement_torch.parallel.mesh import (
    Axis, local_rows, new_axes, whole_axis)


class VolumeMesh(NamedTuple):
    """The axes of a 3D mesh: ``depth`` always, ``data`` for a composed
    mesh (None otherwise), and ``world``, all of its ranks."""
    depth: Axis
    data: Optional[Axis]
    world: Axis


def make_depth_mesh(n: int) -> VolumeMesh:
    """A depth-only mesh over the whole default group of ``n`` ranks."""
    world = whole_axis()
    if world.size != n:
        raise ValueError(f"a depth mesh of {n} needs {n} ranks; the group "
                         f"has {world.size}")
    return VolumeMesh(world, None, world)


def make_volume_mesh(n_data: int, n_depth: int) -> VolumeMesh:
    """The composed ``n_data`` x ``n_depth`` mesh over the default group:
    the batch splits over ``data`` while each volume's depth splits over
    ``depth`` (JAX ``make_volume_mesh``)."""
    world = whole_axis()
    if world.size != n_data * n_depth:
        raise ValueError(f"mesh {n_data}x{n_depth} needs "
                         f"{n_data * n_depth} ranks; the group has "
                         f"{world.size}")
    data, depth = new_axes((n_data, n_depth))
    return VolumeMesh(depth, data, world)


def check_depth(depth: int, n: int) -> None:
    """JAX main_3d's check of a depth for ``n`` depth shards."""
    if depth % n or (depth // 16) % n:
        raise ValueError(f"depth {depth} and {depth}//16 must divide by "
                         f"--depth-shards {n} (parallel/halo.py "
                         "constraints)")


def sharded_nvnet_infer_fn(model, mesh: VolumeMesh):
    """Returns ``infer(x [B, M, H, W, D]) -> (uout, vout, mu, logvar)``,
    the eval-mode forward of the whole volume with its depth split over
    ``mesh.depth``: every rank passes the same x and gets the whole
    outputs back (the blocks all-gathered along the depth).  The model's
    parameters are read at each call, so one function serves every epoch
    (JAX ``sharded_nvnet_infer_fn``)."""
    depth = mesh.depth

    def gather(t):
        return torch.cat(_all_gather(t.contiguous(), depth), -1)

    @torch.no_grad()
    def infer(x: torch.Tensor):
        model.eval()
        with depth_sharded(depth):
            uout, vout, mu, logvar = model(local_rows(x, 4, depth))
        return gather(uout), gather(vout), mu, logvar

    return infer


def _all_gather(t: torch.Tensor, axis: Axis):
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return parts
