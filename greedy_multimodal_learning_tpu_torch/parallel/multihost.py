"""Processes, nodes and devices (``greedy_multimodal_learning_tpu/parallel/multihost.py``).

The JAX package starts ``jax.distributed`` from ``GML_COORDINATOR_ADDRESS``
(one process a host, which drives all the host's devices).  The port runs
one process a device, started by ``torchrun``:

    torchrun --nproc_per_node=N -m greedy_multimodal_learning_tpu_torch.train RUN \\
        "configs/training_guided.gin#configs/training_dp_v5e8.gin"
    torchrun --nproc_per_node=N -m greedy_multimodal_learning_tpu_torch.train RUN \\
        "configs/training_guided.gin#configs/training_dp_v5e8.gin" "training_loop.model_parallel=2"

:func:`maybe_initialize_distributed` makes the process group from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a rank's device
is ``cuda:<LOCAL_RANK>`` (:func:`rank_device`).  Each node's loaders read
:func:`process_local_indices` of every split, and the ranks of a node split
the node's batch (:class:`~.mesh.World`); with ``model_parallel`` the
ranks of a model group take the same rows, and ``model_parallel`` must
divide ``LOCAL_WORLD_SIZE``.

``training_loop.data_parallel`` without such a group runs over a one-rank
group of its own (:func:`join_world`): NCCL on a card, gloo on the CPU, as
the JAX package's mesh spans the devices there are.  Two ranks that share a
card cannot use NCCL; their caller makes a gloo group before the entry,
which then leaves it alone.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from .mesh import World, world_from_process_group

logger = logging.getLogger(__name__)

#: the timeout of the process groups the port makes
GROUP_TIMEOUT = datetime.timedelta(minutes=10)
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(timeout: datetime.timedelta = GROUP_TIMEOUT) -> bool:
    """Make the default process group from ``torchrun``'s environment
    (gloo for CPU tensors, and NCCL for CUDA tensors where there is a
    card).  Returns True when this call made it; False without that
    environment, or when a group is already there (left as it is).  The
    JAX package's ``GML_COORDINATOR_ADDRESS`` raises: the port starts one
    process a device through ``torchrun``."""
    if os.environ.get("GML_COORDINATOR_ADDRESS"):
        raise RuntimeError(
            "GML_COORDINATOR_ADDRESS starts the JAX package's jax.distributed (one process a host); the port runs "
            "one process a device: launch it with torchrun --nproc_per_node=N (RANK, WORLD_SIZE, LOCAL_RANK, "
            "LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT)"
        )
    if dist.is_initialized() or not all(os.environ.get(k) for k in _TORCHRUN_ENV):
        return False
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, init_method="env://", timeout=timeout)
    logger.info("torch.distributed initialized: rank %d of %d (%s), %s ranks a node", dist.get_rank(),
                dist.get_world_size(), backend, os.environ["LOCAL_WORLD_SIZE"])
    return True


def is_main_process() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def node_of_process() -> tuple:
    """(this process's node, nodes), (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    world = world_from_process_group()
    return world.node, world.n_nodes


def rank_device(device) -> torch.device:
    """The device of this rank: a bare ``'cuda'`` becomes
    ``cuda:<LOCAL_RANK>`` under a process group; a device with an index
    (``'cuda:0'``) or the CPU stays as named."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", world_from_process_group().local_rank))
        device = torch.device("cuda", local)
    if device.type == "cuda" and device.index is not None and torch.cuda.is_available():
        torch.cuda.set_device(device)
    return device


def join_world(device, model_parallel: int = 1, timeout: datetime.timedelta = GROUP_TIMEOUT) -> tuple:
    """(the :class:`~.mesh.World` of the default process group with
    ``model_parallel`` ranks a model group, whether this call made the
    group): without one, a one-rank group of this process, NCCL for a card
    and gloo for the CPU, which the caller destroys.  A world or a node
    that ``model_parallel`` does not divide raises ``ValueError`` (a
    one-rank group only after it is destroyed again)."""
    if dist.is_initialized():
        return world_from_process_group(model_parallel), False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, store=dist.HashStore(), rank=0, world_size=1, timeout=timeout)
    logger.info("data parallelism over a one-rank %s group", backend)
    try:
        return world_from_process_group(model_parallel), True
    except ValueError:
        dist.destroy_process_group()
        raise


def leave_world(made: bool) -> None:
    """Destroy the group :func:`join_world` made."""
    if made:
        dist.destroy_process_group()


def process_local_indices(indices, node: int, n_nodes: int) -> list:
    """Node ``node``'s share of a split's indices (``multihost.py:42-64``):
    every ``n_nodes``-th index from its own, each node exactly
    ``ceil(len / n_nodes)`` of them so that every node runs the same number
    of steps; a short share is topped up from the front of the list.
    Identity for one node."""
    indices = list(indices)
    if n_nodes <= 1 or not indices:
        return indices
    per = -(-len(indices) // n_nodes)
    mine = indices[node::n_nodes]
    fill = 0
    while len(mine) < per:
        mine.append(indices[fill % len(indices)])
        fill += 1
    return mine
