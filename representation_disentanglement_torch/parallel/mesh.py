"""Process groups and the data-parallel layer (JAX ``parallel/mesh.py``).

The JAX package compiles its train step once over the global batch and
lets XLA partition it over a ``data`` mesh axis.  Here each card is a
process of ``torch.distributed`` (rank r on ``cuda:r`` over NCCL; gloo on
the CPU, when the caller asks for the CPU), and the step keeps the JAX
step's global semantics instead of DDP's per-rank ones:

- every rank computes on its B/N rows of the global batch;
- the losses gather their small per-sample terms over the ranks
  (``gather_rows``, with autograd), so that every rank computes the loss of
  the global batch: ratios of masked sums, means over present modalities
  and the ``_roll1`` pairing of sample b with b+1 of the global batch come
  out as unsharded;
- BatchNorm takes global statistics (``all_reduce_sum``, models/layers.py
  and ops/fused_bn.py);
- noise is drawn at the global shape from identically seeded generators
  and each rank keeps its rows (``global_shape``, ``local_part``).

Gradients: every rank computes the same (global) loss, so the transpose of
each gather or all-reduce re-broadcasts summed cotangents, and each rank's
parameter gradient is N times its share of the total.  ``all_reduce_grads``
averages them over the ranks, which gives the exact total gradient (JAX's
account of the same pmean: training/train3d.py:138-149).

``data_parallel(axis)`` opens the scope in which the losses, BatchNorm and
the noise draws read the data axis; outside it every function is the
single-card one.

Launching: ``mesh_from_config`` checks ``mesh_shape: {data: N}`` as JAX's
does (enough cards, ``batch_size % N == 0``); an entry point that finds no
process group and no ``RANK``/``WORLD_SIZE`` in its environment starts N
workers itself (``spawn``, a free port on localhost); under ``torchrun`` it
joins the group it is given (``join``).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import pickle
import socket
import tempfile
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One mesh axis: its process group, this process's index on it, its
    size and the global ranks of its members in axis order."""
    group: Any
    rank: int
    size: int
    ranks: Tuple[int, ...]


_DATA: contextvars.ContextVar[Optional[Axis]] = contextvars.ContextVar(
    "rdt_data_axis", default=None)


@contextlib.contextmanager
def data_parallel(axis: Optional[Axis]):
    """The scope of a data-parallel step over ``axis`` (no-op for None)."""
    tok = _DATA.set(axis)
    try:
        yield
    finally:
        _DATA.reset(tok)


def current_data_axis() -> Optional[Axis]:
    return _DATA.get()


# ---------------------------------------------------------------------------
# process groups and launching
# ---------------------------------------------------------------------------

def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def whole_axis() -> Axis:
    """The default group as one axis."""
    n = dist.get_world_size()
    return Axis(None, dist.get_rank(), n, tuple(range(n)))


def new_axes(shape: Sequence[int]) -> Tuple[Axis, ...]:
    """The axes of a row-major mesh of ``shape`` over the default group
    (``prod(shape)`` ranks; rank = i0 * shape[1] + i1 for two axes, as
    ``np.reshape`` of JAX's device list): one process group per line of
    each axis, made by every rank in the same order.  Returns this
    process's axis of each dimension."""
    world, me = dist.get_world_size(), dist.get_rank()
    grid = np.arange(world).reshape(tuple(shape))
    out = []
    for d in range(grid.ndim):
        lines = np.moveaxis(grid, d, -1).reshape(-1, grid.shape[d])
        mine = None
        for line in lines:
            ranks = tuple(int(r) for r in line)
            group = dist.new_group(list(ranks))
            if me in ranks:
                mine = Axis(group, ranks.index(me), len(ranks), ranks)
        out.append(mine)
    return tuple(out)


def device_for_rank(device, local_rank: int) -> torch.device:
    """``cuda:<local rank>`` for a CUDA ``device``; the CPU as it is."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if local_rank >= torch.cuda.device_count():
        raise ValueError(f"rank {local_rank} needs cuda:{local_rank}, but "
                         f"{torch.cuda.device_count()} cards are visible")
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def check_world(n: int, device) -> None:
    """A world of ``n`` processes on ``device``: one card each (JAX
    ``mesh_from_config``'s device check)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"a mesh of {n} processes needs {n} cards, but "
                             f"only {have} are visible")


def launched() -> bool:
    """A process group exists, or the environment describes one
    (``torchrun``)."""
    return dist.is_initialized() or ("RANK" in os.environ
                                     and "WORLD_SIZE" in os.environ)


def join(device) -> torch.device:
    """This process's device in the process group: ``cuda:<local rank>``
    for a CUDA ``device`` without an index, else ``device``.  Without a
    group it joins the one the environment describes (``torchrun``: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = device_for_rank(device, int(os.environ.get(
            "LOCAL_RANK", os.environ.get("RANK", dist.get_rank()
                                         if dist.is_initialized() else 0))))
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), init_method="env://")
    return device


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, n: int, port: int, device, fn: Callable, args,
            kwargs, out_path: str) -> None:
    dev = device_for_rank(device, rank)
    if dev.type == "cpu":           # the ranks share the host's cores
        torch.set_num_threads(1)
    dist.init_process_group(backend_for(dev),
                            init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        result = fn(*args, device=dev, **kwargs)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(n: int, fn: Callable, *args, device=None, **kwargs):
    """Run ``fn(*args, device=<rank's device>, **kwargs)`` in ``n`` new
    processes joined into one group (NCCL on cards 0..n-1, or gloo when
    ``device`` is the CPU) and return rank 0's result.  ``fn`` and its
    arguments must pickle; a worker's exception is raised here."""
    import torch.multiprocessing as mp
    check_world(n, device)
    with tempfile.TemporaryDirectory(prefix="rdt_spawn_") as tmp:
        out = os.path.join(tmp, "result.pkl")
        mp.start_processes(_worker, args=(n, free_port(), device, fn, args,
                                          kwargs, out),
                           nprocs=n, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)


# ---------------------------------------------------------------------------
# the data mesh
# ---------------------------------------------------------------------------

def data_size(cfg) -> int:
    return int((getattr(cfg, "mesh_shape", None) or {}).get("data", 1) or 1)


def mesh_from_config(cfg, device=None) -> Optional[Axis]:
    """The data axis that ``cfg.mesh_shape`` asks for, over the existing
    default group; None for one card outside a process group (a group of
    one rank gives a data axis of one: the DP path on one card).  Raises
    where JAX's ``mesh_from_config`` does (too few cards, ``batch_size``
    not a multiple of N) and where the group's size differs from N."""
    n = data_size(cfg)
    if n <= 1 and not (dist.is_initialized()
                       and dist.get_world_size() == 1):
        return None
    check_world(n, device)
    if cfg.batch_size % n:
        raise ValueError(
            f"batch_size {cfg.batch_size} must be divisible by the data-"
            f"mesh size {n} (the global batch is sharded over the data "
            "axis)")
    if not dist.is_initialized():
        raise RuntimeError(f"mesh_shape data={n} needs a process group "
                           "(main_missing.run starts one)")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh_shape data={n}, but the process group has "
                         f"{dist.get_world_size()} ranks")
    return whole_axis()


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 of the process
    group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def agree(axis: Optional[Axis], flag: bool) -> bool:
    """``flag`` of any rank (a max all-reduce): ranks stop together."""
    if axis is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=_comm_device(axis))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis.group)
    return bool(t.item())


def broadcast_object(obj, axis: Optional[Axis]):
    """Rank 0's ``obj`` on every rank of ``axis``."""
    if axis is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=axis.ranks[0], group=axis.group)
    return box[0]


def _comm_device(axis: Axis) -> torch.device:
    if dist.get_backend(axis.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


_BATCH_AXIS = {          # the sample axis of each batch tensor
    "inputs": 1,         # [M, B, H, W, C]
    "targets": 0,        # [B, H, W, C]
    "mask": 0,           # [B, M]
    "mask_img": 0,       # [B, H, W]
    "slice_idx": 0,
    "valid": 0,
}


def local_rows(t, dim: int, axis: Axis):
    """Block ``axis.rank`` of ``axis.size`` equal blocks along ``dim``."""
    n = t.shape[dim] // axis.size
    if isinstance(t, torch.Tensor):
        return t.narrow(dim, axis.rank * n, n)
    return np.take(np.asarray(t), np.arange(axis.rank * n,
                                            (axis.rank + 1) * n), axis=dim)


def shard_batch(batch: dict, axis: Optional[Axis], stacked: bool = False
                ) -> dict:
    """The rank's rows of a (microbatch-``stacked``) global batch, along
    each tensor's sample axis; ``subj_id`` is cut the same way."""
    if axis is None:
        return batch
    out = {}
    for k, v in batch.items():
        if k == "subj_id":
            n = len(v) // axis.size
            out[k] = list(v)[axis.rank * n:(axis.rank + 1) * n]
            continue
        out[k] = local_rows(v, _BATCH_AXIS.get(k, 0) + int(stacked), axis)
    return out


def shard_epoch_plan(plan, axis: Optional[Axis]):
    """The rank's part of an ``EpochPlan`` of a replicated cache: rows,
    slices [steps, A, B] and drop [steps, A, B, M] on the batch dim; the
    pairs stay whole (JAX shard_epoch_plan, :83-94)."""
    if axis is None:
        return plan
    return type(plan)(local_rows(plan.rows, 2, axis),
                      local_rows(plan.slices, 2, axis),
                      local_rows(plan.drop, 2, axis), plan.sim, plan.adv)


def replicate(tensors: Sequence[torch.Tensor], axis: Optional[Axis]
              ) -> None:
    """Broadcast ``tensors`` in place from the axis's first rank (a host
    tensor, such as Adam's step count, through the group's device)."""
    if axis is None:
        return
    dev = _comm_device(axis)
    for t in tensors:
        buf = t.data if t.device == dev else t.data.to(dev)
        dist.broadcast(buf, src=axis.ranks[0], group=axis.group)
        if buf is not t.data:
            t.data.copy_(buf)


def optimizer_tensors(opt: torch.optim.Optimizer):
    return [v for st in opt.state.values() for v in st.values()
            if isinstance(v, torch.Tensor)]


def replicate_training(model, optimizers, axis: Optional[Axis]) -> None:
    """Parameters, buffers and optimizer state from rank 0 on every rank
    (JAX ``replicate``)."""
    replicate(list(model.parameters()) + list(model.buffers())
              + [t for o in optimizers if o is not None
                 for t in optimizer_tensors(o)], axis)


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]],
                     axis: Optional[Axis]) -> None:
    """Average ``grads`` in place over ``axis`` (one flat buffer)."""
    if axis is None:
        return
    live = [g for g in grads if g is not None]
    if not live:
        return
    flat = torch.cat([g.reshape(-1).float() for g in live])
    dist.all_reduce(flat, group=axis.group)
    flat /= axis.size
    off = 0
    for g in live:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        y = x.clone()
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, differentiable (the
    transpose of a sum over replicas is a sum of their cotangents)."""
    if axis is None:
        return x
    return _AllReduceSum.apply(x, axis)


def all_reduce_mean(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    if axis is None:
        return x
    return all_reduce_sum(x, axis) / axis.size


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        ctx.n = x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


def gather_rows(x: torch.Tensor, dim: int = 0,
                axis: Optional[Axis] = None) -> torch.Tensor:
    """``x`` of every rank of the data axis (default: the current scope's),
    concatenated along ``dim`` in rank order, which is the global batch
    order; differentiable.  Outside a scope, ``x`` itself."""
    axis = axis if axis is not None else _DATA.get()
    if axis is None:
        return x
    return _GatherRows.apply(x, dim, axis)


# ---------------------------------------------------------------------------
# noise at the global shape
# ---------------------------------------------------------------------------

def global_shape(shape, batch_dim: int, depth_dim: Optional[int] = None):
    """``shape`` of a local tensor scaled to the global one: the batch dim
    by the data axis, ``depth_dim`` by the depth axis (ops/conv3d.py)."""
    from representation_disentanglement_torch.ops.conv3d import (
        current_depth_axis)
    shape = list(shape)
    data, depth = _DATA.get(), current_depth_axis()
    if data is not None:
        shape[batch_dim] *= data.size
    if depth is not None and depth_dim is not None:
        shape[depth_dim] *= depth.size
    return shape


def local_part(t: torch.Tensor, batch_dim: int,
               depth_dim: Optional[int] = None) -> torch.Tensor:
    """This rank's block of a tensor drawn at ``global_shape``."""
    from representation_disentanglement_torch.ops.conv3d import (
        current_depth_axis)
    data, depth = _DATA.get(), current_depth_axis()
    if data is not None:
        t = local_rows(t, batch_dim, data)
    if depth is not None and depth_dim is not None:
        t = local_rows(t, depth_dim, depth)
    return t
