"""Evaluation entry point, the port of the repository's ``eval.py``: the
two passes of the conditional-utilization analysis.

    python -m greedy_multimodal_learning_tpu_torch.eval RUN configs/recording.gin \\
        "eval_.pretrained_weights_path='RUN/model_best_val.pt'"
    python -m greedy_multimodal_learning_tpu_torch.eval OUT configs/eval.gin \\
        "MMTM_MVCNN.mmtm_rescale_eval_file_path='RUN/eval_history_batch'#MMTM_MVCNN.mmtm_rescale_training_file_path='RUN'#eval_.pretrained_weights_path='RUN/model_best_val.pt'"

The first records the MMTM squeeze maps over the train split into
``RUN/eval_history_batch/history.pickle``; the second evaluates the test
split with each modality's view of the other's squeeze replaced by its
dataset average, writing ``OUT/eval_history_batch/history.csv``.  Runs on
the GPU (bind ``eval_.device='cpu'`` for the CPU).
"""

from __future__ import annotations

from .entries import eval_
from .parallel import leave_world, maybe_initialize_distributed
from .utils import configure_logger, gin_wrap

if __name__ == "__main__":
    configure_logger("")
    made = maybe_initialize_distributed()
    try:
        gin_wrap(eval_)
    finally:
        leave_world(made)
