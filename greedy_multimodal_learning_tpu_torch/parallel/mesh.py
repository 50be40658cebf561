"""Data parallelism over ``torch.distributed`` ranks: the port's counterpart
of the JAX package's ``('data', 'model')`` mesh with ``model_parallel=1``
(``greedy_multimodal_learning_tpu/parallel/mesh.py``).

The JAX package shards the batch ``P('data')`` over the mesh's devices and
replicates the state; as its step is one program with global-view
semantics, every masked statistic is a reduction over the whole batch.  The
port runs one process a device (a rank) and makes each of those reductions
an explicit collective over the world, so a rank's step computes what the
one-process step computes on the joined batch:

* a rank is a device of the mesh, a node (``torchrun``'s group of
  ``LOCAL_WORLD_SIZE`` ranks) is a JAX process (host);
* on a node the loader's batch is the node's batch, and its local rank
  ``l`` of ``L`` takes rows ``[l·B/L, (l+1)·B/L)``, the block ``P('data')``
  gives device ``l``; the global batch is the nodes' batches in node order,
  so rank ``r``'s block is rows ``[r·b, (r+1)·b)`` of it, ``b = B/L``;
* the model's masked reductions (BatchNorm, the MMTM gate means), the
  loss's valid count, the metrics and the gradients are summed over the
  world (:func:`all_reduce_`, :func:`differentiable_sum`).

The world is the default process group.  Whether the model code reduces
over it is set for the duration of a step by :func:`data_parallel` (the
trainer enters it); outside it, :func:`active` is None and every reduction
stays local.

Every collective is an ``all_reduce`` (SUM) or a ``broadcast``, the two
that both NCCL and gloo carry on CUDA tensors: a gather writes the rank's
rows into a zero buffer of the global shape and sums it (exact), a barrier
sums a scalar.  Each adds one to :func:`collective_count`, at world 1 too.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class World:
    """The ranks a data-parallel run spans: ``size`` ranks of which this is
    ``rank``, ``local_size`` a node."""

    size: int
    rank: int
    local_size: int

    def __post_init__(self):
        if self.size % self.local_size:
            raise ValueError(f"{self.size} ranks do not split into nodes of {self.local_size}")

    @property
    def node(self) -> int:
        return self.rank // self.local_size

    @property
    def n_nodes(self) -> int:
        return self.size // self.local_size

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_size

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a node batch of ``batch_size``; a batch that
        does not split evenly over the node's ranks raises, as the JAX
        package's ``P('data')`` sharding refuses it."""
        if batch_size % self.local_size:
            raise ValueError(
                f"batch size {batch_size} does not split over {self.local_size} ranks a node: data parallelism "
                "needs the batch size to be a multiple of the ranks a node"
            )
        b = batch_size // self.local_size
        return slice(self.local_rank * b, (self.local_rank + 1) * b)


def world_from_process_group() -> World:
    """The :class:`World` of the default process group; a node is
    ``LOCAL_WORLD_SIZE`` ranks (``torchrun``'s), the whole world without
    it."""
    size = dist.get_world_size()
    return World(size=size, rank=dist.get_rank(), local_size=int(os.environ.get("LOCAL_WORLD_SIZE", size)))


_ACTIVE: Optional[World] = None


def active() -> Optional[World]:
    """The world the model's reductions run over, None outside
    :func:`data_parallel`."""
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(world: Optional[World]):
    """Reduce the model's statistics over ``world`` inside the block (None:
    leave them local)."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, world
    try:
        yield world
    finally:
        _ACTIVE = previous


class _Counter:
    count = 0


def collective_count() -> int:
    """Collectives issued since the last :func:`reset_collective_count`."""
    return _Counter.count


def reset_collective_count() -> None:
    _Counter.count = 0


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the world, in place; returns it."""
    _Counter.count += 1
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place; returns it."""
    _Counter.count += 1
    dist.broadcast(tensor, src=src)
    return tensor


class _SumOverWorld(torch.autograd.Function):
    """y = the sum of x over the ranks; the backward sums the ranks'
    upstream gradients the same way, as ``SyncBatchNorm``'s does."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone())


def differentiable_sum(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over the world, differentiable."""
    return _SumOverWorld.apply(tensor)


def gather(tensor: torch.Tensor, world: World) -> torch.Tensor:
    """Every rank's ``tensor`` stacked in rank order, (size, *shape): this
    rank's in a zero buffer, summed over the world (exact)."""
    out = torch.zeros((world.size,) + tuple(tensor.shape), dtype=tensor.dtype, device=tensor.device)
    out[world.rank] = tensor
    return all_reduce_(out)


def barrier(device) -> None:
    """Wait until every rank got here (a summed scalar, read on the host)."""
    all_reduce_(torch.zeros((), device=device)).item()


def _flat_f32(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view(t.shape))
            offset += n


def all_reduce_grads_(params: Sequence[torch.Tensor]) -> None:
    """Sum the gradients of ``params`` over the world in one collective;
    a parameter without a gradient (on every rank alike) is skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _unflatten_into(all_reduce_(_flat_f32(grads)), grads)


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s floating parameters and buffers on every rank, in one
    collective."""
    tensors = [t for t in (*module.parameters(), *module.buffers()) if t.is_floating_point()]
    if tensors:
        _unflatten_into(broadcast_(_flat_f32(tensors), src), tensors)
