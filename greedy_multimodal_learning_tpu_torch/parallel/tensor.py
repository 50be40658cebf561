"""Tensor parallelism over a world's model groups: the port's counterpart of
the JAX package's ``param_pspec`` / ``shard_params`` / ``shard_train_state``
(``greedy_multimodal_learning_tpu/parallel/mesh.py:30-111``).

**Which weights.**  The JAX package shards every parameter leaf of two or
more dimensions whose last dimension, its output dimension in flax's
layout (HWIO, (kt, kh, kw, I, O), (in, out)), is at least
``min_shard_dim`` and a multiple of the model size; the rest stays
replicated.  The port's layout puts the output dimension first
((O, I, kh, kw), (O, I, kt, kh, kw), (O, I)), so :func:`shardable` applies
the same rule to dimension 0.  Biases, BatchNorm and the MMTM buffers stay
whole.

**How a rank holds one.**  :func:`shard_module_` keeps this rank's block of
``O / model_size`` output rows as the module's parameter (the same
``nn.Parameter`` object, so the optimizer keeps it) and slices its SGD
momentum buffer alike; the module's ``shard`` (:class:`Shard`) then turns
its forward column-parallel (:func:`column_parallel`):

1. the input through an op that is the identity forward and sums its
   gradient over the model group backward (each rank's input gradient is
   the part its output rows contribute);
2. the convolution or linear on the rank's rows;
3. the output rows of the model group joined along the channel dimension
   (:class:`_GatherRows`), whose backward keeps the rank's own block: what
   follows runs replicated on every rank of the group, so they all hold the
   same upstream gradient.

A linear's bias is whole and added after the join.  A replicated
tensor's gradient is the model group's first rank's on all of its ranks
(:func:`all_reduce_grads_`), so every rank of the group updates its copy
with the same bits.  The MMTM gating kernel takes whole matrices, as XLA
hands a custom call whole operands: its weights come through the same join
(:func:`full_weight`).

**Collectives.**  As in :mod:`.mesh`, only ``all_reduce``: a join writes the
rank's block into a zero buffer of the whole shape and sums it over the
model group (exact), which NCCL and gloo on CUDA tensors both carry.

**Whole tensors.**  Checkpoints, BatchNorm folding and loads see the
weights whole: :func:`unsharded` joins every sharded weight and momentum
buffer on every rank for the duration of a block and keeps each rank's rows
again after it, so the files have the names and full shapes a one-rank run
writes and a checkpoint loads at any model size.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from . import mesh


@dataclass(frozen=True)
class Shard:
    """A weight split over a model group of ``size`` ranks, of which this is
    ``index``; ``rows`` is its whole dimension 0."""

    group: object
    size: int
    index: int
    rows: int

    @property
    def block(self) -> int:
        return self.rows // self.size

    def take(self, full: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``full`` along ``dim`` (a view)."""
        return full.narrow(dim, self.index * self.block, self.block)


def shardable(shape, model_size: int, min_shard_dim: int) -> bool:
    """The JAX package's rule (``param_pspec`` and the divisibility check
    of ``shard_params``) on the port's output-first layout."""
    return len(shape) >= 2 and shape[0] >= min_shard_dim and shape[0] % model_size == 0


def _dense_clone(t: torch.Tensor) -> torch.Tensor:
    """A dense copy of ``t`` in its memory format (channels-last maps stay
    channels-last)."""
    return torch.empty_like(t, memory_format=torch.preserve_format).copy_(t)


def _memory_format(t: torch.Tensor):
    for fmt, dims in ((torch.channels_last, 4), (torch.channels_last_3d, 5)):
        if t.dim() == dims and t.is_contiguous(memory_format=fmt):
            return fmt
    return torch.contiguous_format


def _join(block: torch.Tensor, shard: Shard, dim: int) -> torch.Tensor:
    """The model group's blocks along ``dim``: this rank's in a zero buffer
    of the whole shape (in the block's memory format), summed."""
    shape = list(block.shape)
    shape[dim] = shard.rows
    out = torch.empty(shape, dtype=block.dtype, device=block.device, memory_format=_memory_format(block)).zero_()
    shard.take(out, dim).copy_(block)
    return mesh.all_reduce_(out, shard.group)


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return mesh.all_reduce_(_dense_clone(grad), ctx.shard.group), None


class _GatherRows(torch.autograd.Function):
    """The model group's blocks joined along ``dim``; the gradient's own
    block backward."""

    @staticmethod
    def forward(ctx, block, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return _join(block, shard, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.take(grad, ctx.dim), None, None


def column_parallel(fn, x: torch.Tensor, shard: Shard, dim: int) -> torch.Tensor:
    """``fn`` (a convolution or linear on this rank's output rows) of ``x``,
    its output joined over the model group along ``dim``."""
    return _GatherRows.apply(fn(_CopyToModel.apply(x, shard)), shard, dim)


def full_weight(module) -> torch.Tensor:
    """``module.weight`` whole: joined over the model group when it is
    sharded (differentiable; the gradient's own rows backward)."""
    shard = getattr(module, "shard", None)
    return module.weight if shard is None else _GatherRows.apply(module.weight, shard, 0)


def sharded_weights(model: torch.nn.Module) -> dict:
    """{parameter: :class:`Shard`} of the model's sharded weights."""
    return {m.weight: m.shard for m in model.modules() if getattr(m, "shard", None) is not None}


def all_reduce_grads_(model: torch.nn.Module, params, world) -> None:
    """The step's gradients of ``params`` summed over the data group; above
    model size 1 the replicated ones are then the first rank's of the model
    group on all of its ranks (one broadcast).  Each rank of a model group
    updates its own copy of every replicated tensor, so the copies stay
    equal only if they take the same gradient: a backward that rounds
    differently on each rank (a cuDNN algorithm that accumulates in any
    order, say) would otherwise drift them apart step by step."""
    mesh.all_reduce_grads_(params, world.data_group)
    if world.model_size > 1:
        shards = sharded_weights(model)
        mesh.broadcast_grads_([p for p in params if p not in shards], world.data_index * world.model_size,
                              world.model_group)


def shard_module_(model: torch.nn.Module, world, min_shard_dim: int = 256, optimizer=None) -> list:
    """Keep this rank's rows of every weight :func:`shardable` selects (and
    of its momentum buffer in ``optimizer``, where it has one); returns the
    sharded parameters' names.  Each one must belong to a layer with a
    column-parallel forward (``models/layers.py``), else this raises.
    Nothing to do at model size 1."""
    if world.model_size == 1:
        return []
    names = []
    for name, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            if not shardable(p.shape, world.model_size, min_shard_dim):
                continue
            if pname != "weight" or not hasattr(module, "shard"):
                raise TypeError(f"{name}.{pname} {tuple(p.shape)} is selected for tensor parallelism, but "
                                f"{type(module).__name__} has no column-parallel forward")
            if module.shard is not None:
                raise RuntimeError(f"{name}.{pname} is sharded already")
            shard = Shard(world.model_group, world.model_size, world.model_index, p.shape[0])
            with torch.no_grad():
                p.data = _dense_clone(shard.take(p.data))
            p.grad = None
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            if state.get("momentum_buffer") is not None:
                state["momentum_buffer"] = _dense_clone(shard.take(state["momentum_buffer"]))
            module.shard = shard
            names.append(f"{name}.{pname}" if name else pname)
    return names


def is_sharded(model: torch.nn.Module) -> bool:
    return bool(sharded_weights(model))


def _momentum(optimizer, p):
    return None if optimizer is None else optimizer.state.get(p, {}).get("momentum_buffer")


@contextlib.contextmanager
def unsharded(model: torch.nn.Module, optimizer=None):
    """Inside the block every sharded weight, and its momentum buffer in
    ``optimizer``, is whole on every rank (joined over the model group,
    exact); after it each rank keeps its rows of whatever the block left
    there (a load included).  Every rank of the model group enters it.
    Nothing happens for a model that is not sharded."""
    shards = sharded_weights(model)
    with torch.no_grad():
        for p, shard in shards.items():
            p.data = _join(p.data, shard, 0)
            buf = _momentum(optimizer, p)
            if buf is not None:
                optimizer.state[p]["momentum_buffer"] = _join(buf, shard, 0)
    try:
        yield model
    finally:
        with torch.no_grad():
            for p, shard in shards.items():
                p.data = _dense_clone(shard.take(p.data))
                buf = _momentum(optimizer, p)
                if buf is not None and buf.shape[0] == shard.rows:
                    optimizer.state[p]["momentum_buffer"] = _dense_clone(shard.take(buf))


def slice_state(model: torch.nn.Module, state: dict) -> dict:
    """``state`` (whole tensors by state_dict name) with this rank's rows of
    the entries that are sharded weights of ``model``."""
    shards = {f"{name}.weight": m.shard for name, m in model.named_modules() if getattr(m, "shard", None) is not None}
    return {k: (shards[k].take(v) if k in shards else v) for k, v in state.items()}
