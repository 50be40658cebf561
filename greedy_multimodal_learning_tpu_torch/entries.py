"""The configurable training entry (``greedy_multimodal_learning_tpu/entries.py:39-91``),
driven by ``python -m greedy_multimodal_learning_tpu_torch.train``."""

from __future__ import annotations

import logging

import torch

from . import config as cfg
from .bootstrap import build_model_and_loaders, init_model, resolve_device
from .engine import callbacks as avail_callbacks
from .engine import make_optimizer, training_loop

logger = logging.getLogger(__name__)

# The callbacks train.callbacks may name; the JAX package's other
# controllers are not ported yet.
CALLBACKS = {
    name: getattr(avail_callbacks, name)
    for name in ("Bias_Mitigation_Strong", "CompletedStopping", "ReduceLROnPlateau_PyTorch", "ProgressionCallback")
}
NOT_PORTED = ("Bias_Mitigation_Random", "Bias_Mitigation_Weakest", "Bias_Mitigation_AdaptiveWeakest")


def set_matmul_precision(precision):
    """``matmul_precision`` as the TF32 switches of float32 matmuls and
    convolutions: ``'highest'`` (or ``'float32'``) turns both off, any other
    value turns both on, None leaves PyTorch's defaults."""
    if precision is None:
        return
    allow = precision not in ("highest", "float32")
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def construct_callbacks(names):
    """Callbacks by name; an unknown name raises KeyError (``entries.py:60-65``)."""
    out = []
    for name in names:
        if name in NOT_PORTED:
            raise NotImplementedError(f"callback {name!r} (its controller) is not ported yet (see ROADMAP.md)")
        if name not in CALLBACKS:
            raise KeyError(f"Unknown callback {name!r} in train.callbacks")
        out.append(CALLBACKS[name]())
    return out


@cfg.configurable
def train(save_path, wd=0.0, lr=0.1, momentum=0.0, batch_size=8, callbacks=(), seed=777, model="MMTM_MVCNN",
          matmul_precision=None, device="cuda"):
    """Build the model, data and optimizer and run :func:`training_loop`.
    Runs on the card unless ``device='cpu'`` is bound.  Returns the
    :class:`~.engine.framework.Trainer`."""
    device = resolve_device(device)
    set_matmul_precision(matmul_precision)
    net, (train_loader, valid_loader, test_loader) = build_model_and_loaders(model, batch_size)
    custom = construct_callbacks(callbacks)
    net = init_model(net, seed, device)
    optimizer = make_optimizer(net.parameters(), lr=lr, momentum=momentum, weight_decay=wd)
    return training_loop(
        model=net,
        optimizer=optimizer,
        train=train_loader,
        valid=valid_loader,
        test=test_loader,
        steps_per_epoch=len(train_loader),
        validation_steps=len(valid_loader),
        test_steps=len(test_loader),
        save_path=save_path,
        config=cfg.CONFIG,
        custom_callbacks=custom,
        nummodalities=net.num_towers,
        device=device,
        seed=seed,
    )
