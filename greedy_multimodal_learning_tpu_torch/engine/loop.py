"""``training_loop`` (``greedy_multimodal_learning_tpu/engine/loop.py:80-285``):
callbacks, history and checkpoints around :meth:`Trainer.train_loop`, with
the reference quirks the JAX package keeps:

* ``n_epochs - 1`` epochs run (``loop.py:279``),
* ``history.pkl`` is removed at start while ``history.pickle`` is written
  (``loop.py:141-146``),
* the structured ``history.pickle`` is written only when custom callbacks
  are present (``loop.py:147,164``),
* best-val checkpointing is dropped on an empty validation split
  (``loop.py:154-167``).

``resume``, ``data_parallel``, ``model_parallel`` other than 1, ``orbax_dir``
and ``fold_bn_eval`` are not ported and raise.
"""

from __future__ import annotations

import logging
import os
from functools import partial

from .. import config as cfg
from .callbacks import LambdaCallback, ModelCheckpoint
from .framework import Trainer
from .history import append_to_history, save_history

logger = logging.getLogger(__name__)


def _remove_stale(paths):
    for p in paths:
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


def _construct_default_callbacks(H, save_path, checkpoint_monitor, save_with_structure=False):
    return [
        LambdaCallback(on_epoch_end=partial(append_to_history, H=H)),
        LambdaCallback(
            on_epoch_end=partial(save_history, save_path=save_path, H=H, save_with_structure=save_with_structure)
        ),
        ModelCheckpoint(os.path.join(save_path, "model_best_val.pt"), checkpoint_monitor),
        LambdaCallback(on_epoch_end=lambda epoch, logs: logger.info("Saving model from epoch %s", epoch)),
    ]


def _detect_controller(custom_callbacks):
    for clbk in custom_callbacks:
        kind = getattr(clbk, "controller_kind", "none")
        if kind != "none":
            return kind, clbk.controller_config()
    return "none", {}


@cfg.configurable
def training_loop(
    model,
    optimizer,
    config,
    save_path,
    steps_per_epoch,
    train=None,
    valid=None,
    test=None,
    test_steps=None,
    validation_steps=None,
    use_gpu=False,
    device_numbers=(0,),
    custom_callbacks=(),
    checkpoint_monitor="val_acc",
    n_epochs=100,
    verbose=True,
    nummodalities=2,
    resume=False,
    data_parallel=False,
    model_parallel=1,
    orbax_dir=None,
    fold_bn_eval=False,
    device="cuda",
    seed=777,
):
    """Train ``model`` (already on ``device``) with ``optimizer``; returns
    the :class:`Trainer`.  ``use_gpu``/``device_numbers`` are accepted for
    the gin surface and ignored."""
    for name, value in (("resume", resume), ("data_parallel", data_parallel), ("orbax_dir", orbax_dir),
                        ("fold_bn_eval", fold_bn_eval), ("model_parallel", model_parallel != 1)):
        if value:
            raise NotImplementedError(f"training_loop.{name} is not ported yet (see ROADMAP.md)")
    callbacks = list(custom_callbacks)
    os.makedirs(save_path, exist_ok=True)

    history_csv_path = os.path.join(save_path, "history.csv")
    history_pkl_path = os.path.join(save_path, "history.pkl")
    logger.info("Removing %s and %s", history_pkl_path, history_csv_path)
    _remove_stale([history_pkl_path, history_csv_path])

    H = {}
    empty_val = not validation_steps or (valid is not None and len(valid) == 0)
    drop_best_val = empty_val and checkpoint_monitor.startswith("val")
    if drop_best_val:
        logger.warning(
            "Empty validation split (validation_steps=%s): %s would be a constant 0.0; best-val "
            "checkpointing is off for this run and only model_last_epoch.pt is written",
            validation_steps, checkpoint_monitor,
        )
    defaults = _construct_default_callbacks(H, save_path, checkpoint_monitor, save_with_structure=bool(custom_callbacks))
    if drop_best_val:
        defaults = [c for c in defaults if not isinstance(c, ModelCheckpoint)]
    callbacks += defaults

    kind, ctrl_cfg = _detect_controller(custom_callbacks)
    trainer = Trainer(
        model,
        optimizer,
        controller_kind=kind,
        controller_config=ctrl_cfg,
        nummodalities=nummodalities,
        verbose=verbose,
        device=device,
        seed=seed,
    )
    for clbk in callbacks:
        clbk.set_save_path(save_path)
        clbk.set_model(trainer, ignore=False)
        clbk.set_optimizer(optimizer)
        clbk.set_config(config)
        clbk.set_model_pytoune(trainer)

    last_ckpt = os.path.join(save_path, "model_last_epoch.pt")
    callbacks.append(LambdaCallback(on_epoch_end=lambda epoch, logs: trainer.save_weights(last_ckpt)))

    trainer.train_loop(
        train,
        valid_generator=valid,
        test_generator=test,
        test_steps=test_steps,
        validation_steps=validation_steps,
        steps_per_epoch=steps_per_epoch,
        epochs=n_epochs - 1,  # quirk #3 (reference: src/training_loop.py:141)
        callbacks=callbacks,
    )
    return trainer
