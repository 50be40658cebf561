"""The configurable entries (``greedy_multimodal_learning_tpu/entries.py``):
``train`` (``:39-91``), driven by ``python -m
greedy_multimodal_learning_tpu_torch.train``, and ``eval_`` (``:94-157``),
driven by ``python -m greedy_multimodal_learning_tpu_torch.eval`` or, in
process, by :func:`~.run_api.run_entry`.  With ``MMTM_MVCNN.pretraining``
both start every tower from a local torchvision ResNet-18 trunk after the
seeded initialization (``entries.py:69-75,139-143``).

Both start ``torch.distributed`` from ``torchrun``'s environment when it is
there (:func:`~.parallel.maybe_initialize_distributed`); a rank then runs
on ``cuda:<LOCAL_RANK>`` unless the bindings name a device
(:func:`~.parallel.rank_device`), and ``training_loop.data_parallel`` /
``evalution_loop.data_parallel`` run over the ranks."""

from __future__ import annotations

import logging

import torch

from . import config as cfg
from . import parallel
from .analysis import get_rescale_weights
from .bootstrap import build_model_and_loaders, init_model, resolve_device, select_split
from .engine import callbacks as avail_callbacks
from .engine import evalution_loop, make_optimizer, training_loop
from .models import apply_pretrained_trunks, resolve_pretrained_path

logger = logging.getLogger(__name__)

# The callbacks train.callbacks and eval_.callbacks may name.
CALLBACKS = {
    name: getattr(avail_callbacks, name)
    for name in ("Bias_Mitigation_Strong", "Bias_Mitigation_Random", "Bias_Mitigation_Weakest",
                 "Bias_Mitigation_AdaptiveWeakest", "CompletedStopping", "ReduceLROnPlateau_PyTorch",
                 "ProgressionCallback")
}


def set_matmul_precision(precision):
    """``matmul_precision`` as the TF32 switches of float32 matmuls and
    convolutions: ``'highest'`` (or ``'float32'``) turns both off, any other
    value turns both on, None leaves PyTorch's defaults."""
    if precision is None:
        return
    allow = precision not in ("highest", "float32")
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def init_with_pretrained(net, seed, device):
    """The seeded model on ``device``, its towers' trunks then replaced by
    the ``MMTM_MVCNN.pretraining`` weights when that is on."""
    net = init_model(net, seed, device)
    path = resolve_pretrained_path()
    if path:
        apply_pretrained_trunks(net, path, net.num_towers)
    return net


def construct_callbacks(names, where="train.callbacks"):
    """Callbacks by name; an unknown name raises KeyError (``entries.py:60-65``)."""
    out = []
    for name in names:
        if name not in CALLBACKS:
            raise KeyError(f"Unknown callback {name!r} in {where}")
        out.append(CALLBACKS[name]())
    return out


@cfg.configurable
def train(save_path, wd=0.0, lr=0.1, momentum=0.0, batch_size=8, callbacks=(), seed=777, model="MMTM_MVCNN",
          matmul_precision=None, device="cuda"):
    """Build the model, data and optimizer and run :func:`training_loop`.
    Runs on the card unless ``device='cpu'`` is bound.  Returns the
    :class:`~.engine.framework.Trainer`."""
    parallel.maybe_initialize_distributed()
    device = resolve_device(parallel.rank_device(device))
    set_matmul_precision(matmul_precision)
    net, (train_loader, valid_loader, test_loader) = build_model_and_loaders(model, batch_size, device)
    custom = construct_callbacks(callbacks)
    net = init_with_pretrained(net, seed, device)
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


@cfg.configurable
def eval_(save_path, target_data_split="test", pretrained_weights_path=None, batch_size=128, callbacks=(), seed=777,
          model="MMTM_MVCNN", matmul_precision=None, device="cuda"):
    """Evaluate a checkpoint on a data split with :func:`evalution_loop`.
    With ``MMTM_MVCNN.mmtm_off=True`` the dataset-average squeeze maps come
    from the recording named by ``MMTM_MVCNN.mmtm_rescale_eval_file_path``
    and the training run at ``mmtm_rescale_training_file_path``, and every
    MMTM runs with the cross-modal flow cut.  Runs on the card unless
    ``device='cpu'`` is bound.  Returns the
    :class:`~.engine.framework.Trainer`."""
    parallel.maybe_initialize_distributed()
    device = resolve_device(parallel.rank_device(device))
    set_matmul_precision(matmul_precision)
    model_scope = model  # gin scope of the model family's bindings
    net, loaders = build_model_and_loaders(model, batch_size, device)
    target = select_split(loaders, target_data_split)

    mmtm_off = bool(cfg.query(model_scope, "mmtm_off", False))
    average_squeezemaps = None
    if mmtm_off:
        average_squeezemaps = get_rescale_weights(
            cfg.query(model_scope, "mmtm_rescale_eval_file_path"),
            cfg.query(model_scope, "mmtm_rescale_training_file_path"),
            validation=False,
            starting_mmtmindice=1,
            mmtmpositions=4,
        )
    custom = construct_callbacks(callbacks, "eval_.callbacks")
    net = init_with_pretrained(net, seed, device)
    return evalution_loop(
        model=net,
        config=cfg.CONFIG,
        save_path=save_path,
        test=target,
        test_steps=len(target),
        custom_callbacks=custom,
        pretrained_weights_path=pretrained_weights_path,
        nummodalities=net.num_towers,
        average_squeezemaps=average_squeezemaps,
        mmtm_off=mmtm_off,
        device=device,
    )
