"""Training entry point, the port of the repository's ``train.py``.

    python -m greedy_multimodal_learning_tpu_torch.train SAVE_PATH CONFIG.gin [BINDINGS]

Trains on the GPU (bind ``train.device='cpu'`` for the CPU) and writes the
JAX package's artifacts to SAVE_PATH: ``history.csv``, ``history.pickle``
(with custom callbacks), ``model_best_val.pt`` and ``model_last_epoch.pt``
(each with a ``.torch.pt`` sidecar), ``stdout.txt``.  Data parallel over
the cards of a node, one process each:

    torchrun --nproc_per_node=N -m greedy_multimodal_learning_tpu_torch.train SAVE_PATH \
        "configs/training_guided.gin#configs/training_dp_v5e8.gin"
"""

from __future__ import annotations

from .entries import train
from .parallel import leave_world, maybe_initialize_distributed
from .utils import configure_logger, gin_wrap

if __name__ == "__main__":
    configure_logger("")
    made = maybe_initialize_distributed()
    try:
        gin_wrap(train)
    finally:
        leave_world(made)
