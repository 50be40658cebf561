"""Data and tensor parallelism over ``torch.distributed`` ranks
(``greedy_multimodal_learning_tpu/parallel``): see :mod:`.mesh` for what a
rank computes, :mod:`.tensor` for the weights split over a model group and
:mod:`.multihost` for processes, nodes and devices."""

from .mesh import (
    World,
    active,
    all_reduce_,
    barrier,
    broadcast_,
    broadcast_module_,
    collective_bytes,
    collective_count,
    data_parallel,
    differentiable_sum,
    gather,
    reset_collective_count,
    world_from_process_group,
)
from .multihost import (
    is_main_process,
    join_world,
    leave_world,
    maybe_initialize_distributed,
    node_of_process,
    process_local_indices,
    rank_device,
)
