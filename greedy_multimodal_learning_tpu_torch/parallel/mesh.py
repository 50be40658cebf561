"""Data and tensor parallelism over ``torch.distributed`` ranks: the port's
counterpart of the JAX package's ``('data', 'model')`` mesh
(``greedy_multimodal_learning_tpu/parallel/mesh.py``).

The JAX package shards the batch ``P('data')`` over the mesh's data axis,
the wide kernels over its model axis (``model_parallel``) and replicates the
rest; as its step is one program with global-view semantics, every masked
statistic is a reduction over the whole batch.  The port runs one process a
device (a rank) on a grid of ``size / model_size`` data indices by
``model_size`` model indices, as ``make_mesh`` reshapes its devices: rank
``r`` has data index ``r // model_size`` and model index
``r % model_size``.  The ``model_size`` consecutive ranks of one data index
form its model group and hold the same rows; the ranks of one model index
form its data group.  Each statistic becomes an explicit collective over the
data group, so a rank's step computes what the one-process step computes on
the joined batch:

* a rank is a device of the mesh, a node (``torchrun``'s group of
  ``LOCAL_WORLD_SIZE`` ranks) is a JAX process (host), and a model group
  never spans nodes;
* on a node the loader's batch is the node's batch, split over the node's
  ``L / model_size`` data indices: local data index ``l`` takes rows
  ``[l·b, (l+1)·b)``, ``b = B·model_size/L``, the block ``P('data')``
  gives it; the global batch is the nodes' batches in node order, so data
  index ``d``'s block is rows ``[d·b, (d+1)·b)`` of it;
* the model's masked reductions (BatchNorm, the MMTM gate means), the
  loss's valid count, the metrics and the gradients are summed over the
  data group (:func:`all_reduce_`, :func:`differentiable_sum` with
  ``world.data_group``); the wide weights are split over the model group
  (:mod:`.tensor`).

At ``model_size`` 1 the data group is the world (the default process
group) and no subgroup is made.  Whether the model code reduces over a world
is set for the duration of a step by :func:`data_parallel` (the trainer
enters it); outside it, :func:`active` is None and every reduction stays
local.

Every collective is an ``all_reduce`` (SUM) or a ``broadcast``, the two
that both NCCL and gloo carry on CUDA tensors: a gather writes the rank's
rows into a zero buffer of the global shape and sums it (exact), a barrier
sums a scalar.  Each adds one to :func:`collective_count`, and its bytes
to its group's in :func:`collective_bytes`, at world 1 too.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class World:
    """The ranks a run spans: ``size`` ranks of which this is ``rank``,
    ``local_size`` a node, ``model_size`` a model group; the process groups
    of this rank's data and model groups (None at ``model_size`` 1: the
    data group is then the default group, and there is no model group)."""

    size: int
    rank: int
    local_size: int
    model_size: int = 1
    data_group: object = field(default=None, compare=False, repr=False)
    model_group: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.size % self.local_size:
            raise ValueError(f"{self.size} ranks do not split into nodes of {self.local_size}")
        if self.size % self.model_size:
            raise ValueError(f"model_parallel={self.model_size} does not divide the {self.size} ranks")
        if self.local_size % self.model_size:
            raise ValueError(
                f"model_parallel={self.model_size} does not divide the {self.local_size} ranks of a node: a model "
                "group must not span nodes"
            )

    @property
    def node(self) -> int:
        return self.rank // self.local_size

    @property
    def n_nodes(self) -> int:
        return self.size // self.local_size

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_size

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def data_size(self) -> int:
        return self.size // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a node batch of ``batch_size``: its data
        index's block, the same on every rank of a model group.  A batch that
        does not split evenly over the node's data indices raises, as the JAX
        package's ``P('data')`` sharding refuses it."""
        slots = self.local_size // self.model_size
        if batch_size % slots:
            raise ValueError(
                f"batch size {batch_size} does not split over the {slots} data indices of a node: data "
                "parallelism needs the batch size to be a multiple of the ranks a node (over model_parallel)"
            )
        b = batch_size // slots
        slot = self.local_rank // self.model_size
        return slice(slot * b, (slot + 1) * b)


def world_from_process_group(model_parallel: int = 1) -> World:
    """The :class:`World` of the default process group; a node is
    ``LOCAL_WORLD_SIZE`` ranks (``torchrun``'s), the whole world without
    it.  With ``model_parallel`` > 1 every rank makes every model group,
    then every data group, in that order (``dist.new_group``), and keeps
    its own two; a world or a node that ``model_parallel`` does not divide
    raises ``ValueError`` first, on every rank alike."""
    size = dist.get_world_size()
    world = World(size=size, rank=dist.get_rank(), local_size=int(os.environ.get("LOCAL_WORLD_SIZE", size)),
                  model_size=int(model_parallel))
    if world.model_size == 1:
        return world
    tp = world.model_size
    model_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp))) for d in range(world.data_size)]
    data_groups = [dist.new_group(list(range(m, size, tp))) for m in range(tp)]
    return replace(world, data_group=data_groups[world.model_index], model_group=model_groups[world.data_index])


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
    nbytes: dict = {}

    @classmethod
    def add(cls, tensor: torch.Tensor, group) -> None:
        cls.count += 1
        cls.nbytes[group] = cls.nbytes.get(group, 0) + tensor.numel() * tensor.element_size()


def collective_count() -> int:
    """Collectives issued since the last :func:`reset_collective_count`."""
    return _Counter.count


def collective_bytes() -> dict:
    """{group (None: the world): bytes of the tensors its collectives
    carried} since the last :func:`reset_collective_count`."""
    return dict(_Counter.nbytes)


def reset_collective_count() -> None:
    _Counter.count = 0
    _Counter.nbytes = {}


def all_reduce_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` (None: the world), in place; returns it."""
    _Counter.add(tensor, group)
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` (``src`` a rank of the world) on every rank
    of ``group`` (None: the world), in place; returns it."""
    _Counter.add(tensor, group)
    dist.broadcast(tensor, src=src, group=group)
    return tensor


class _SumOverGroup(torch.autograd.Function):
    """y = the sum of x over the group's ranks; the backward sums the ranks'
    upstream gradients the same way, as ``SyncBatchNorm``'s does."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def differentiable_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` summed over ``group`` (None: the world), differentiable."""
    return _SumOverGroup.apply(tensor, group)


def gather(tensor: torch.Tensor, world: World) -> torch.Tensor:
    """Every data index's ``tensor`` stacked in data-index order,
    (data_size, *shape): this rank's in a zero buffer, summed over its data
    group (exact).  The ranks of a model group hold the same rows, so one
    rank a data index stands for them."""
    out = torch.zeros((world.data_size,) + tuple(tensor.shape), dtype=tensor.dtype, device=tensor.device)
    out[world.data_index] = tensor
    return all_reduce_(out, world.data_group)


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


def all_reduce_grads_(params: Sequence[torch.Tensor], group=None) -> None:
    """Sum the gradients of ``params`` over ``group`` (None: the world) in
    one collective; a parameter without a gradient (on every rank alike) is
    skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _unflatten_into(all_reduce_(_flat_f32(grads), group), grads)


def broadcast_grads_(params: Sequence[torch.Tensor], src: int, group=None) -> None:
    """Rank ``src``'s gradients of ``params`` on every rank of ``group``, in
    one collective; a parameter without a gradient is skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _unflatten_into(broadcast_(_flat_f32(grads), src, group), grads)


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s floating parameters and buffers on every rank, in one
    collective."""
    tensors = [t for t in (*module.parameters(), *module.buffers()) if t.is_floating_point()]
    if tensors:
        _unflatten_into(broadcast_(_flat_f32(tensors), src), tensors)
