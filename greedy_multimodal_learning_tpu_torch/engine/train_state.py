"""The optimizer and the run's keys
(``greedy_multimodal_learning_tpu/engine/train_state.py:39-67``).

``torch.optim.SGD(lr, momentum, weight_decay)`` is ``make_optimizer``'s optax
chain: the decay is added to the gradient, the momentum trace (whose first
step equals the gradient) follows, then the step is scaled by the lr.
"""

from __future__ import annotations

import torch

from ..utils import prng


def train_keys(seed: int):
    """(init key, data key) of ``train.seed``: ``split(PRNGKey(seed))``, as
    ``create_train_state`` splits it (``train_state.py:57``); the first
    keys the parameters' initialization, the second the train flips."""
    init_key, data_key = prng.split(prng.PRNGKey(seed))
    return init_key, data_key


def make_optimizer(params, lr: float, momentum: float = 0.0, weight_decay: float = 0.0) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
