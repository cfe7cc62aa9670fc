"""Channel (tensor) parallelism for NVNet3D's forward (JAX
``parallel/tp.py``).

JAX shards each kernel's output-channel axis over a ``model`` mesh axis
where it divides by the mesh and holds at least two channels per device
(``channel_sharding``, JAX tp.py:28-38), and lets XLA insert the
collectives.  Here, inside ``channel_parallel(axis)``, every 3D
convolution (ops/conv3d.conv3d) whose output channels satisfy the same rule
computes only rank r's block of them and all-gathers the blocks along the
channel dim before the next layer; the rest of the model (GroupNorm, the
VAE's linears, the 1-channel heads that do not divide) runs replicated.  A
forward only, as JAX's is (tests/test_tp_and_retrieval.py).

Usage, in every rank of a process group::

    axis = parallel.mesh.whole_axis()
    with torch.no_grad(), channel_parallel(axis):
        uout, vout, mu, logvar = model(x)
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist

from representation_disentanglement_torch.parallel.mesh import Axis

_MODEL: contextvars.ContextVar[Optional[Axis]] = contextvars.ContextVar(
    "rdt_model_axis", default=None)


@contextlib.contextmanager
def channel_parallel(axis: Axis):
    """The scope in which 3D convolutions shard their output channels over
    ``axis``."""
    tok = _MODEL.set(axis)
    try:
        yield
    finally:
        _MODEL.reset(tok)


def channel_sharding(channels: int, n: int) -> bool:
    """Whether ``channels`` output channels shard over ``n`` ranks: they
    divide by n and there are at least 2n (JAX ``channel_sharding``)."""
    return channels % n == 0 and channels >= 2 * n


def channel_block(w: torch.Tensor, b: Optional[torch.Tensor]):
    """(w, b, gather) for a convolution of kernel ``w`` [Co, ...] and bias
    ``b``: outside a scope, or where Co does not shard, the arguments and
    the identity; else rank r's block of the output channels and the
    all-gather that rebuilds [B, Co, ...] from the ranks' outputs."""
    axis = _MODEL.get()
    co = w.shape[0]
    if axis is None or not channel_sharding(co, axis.size):
        return w, b, lambda y: y
    k = co // axis.size
    lo = axis.rank * k
    w = w[lo:lo + k]
    b = None if b is None else b[lo:lo + k]

    def gather(y):
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(axis.size)]
        dist.all_gather(parts, y, group=axis.group)
        return torch.cat(parts, 1)

    return w, b, gather
