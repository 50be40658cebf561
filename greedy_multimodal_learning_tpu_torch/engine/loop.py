"""``training_loop`` and ``evalution_loop`` [sic]
(``greedy_multimodal_learning_tpu/engine/loop.py:80-429``): callbacks,
history and checkpoints around :meth:`Trainer.train_loop` and
:meth:`Trainer.eval_loop`, with the reference quirks the JAX package keeps:

* ``n_epochs - 1`` epochs run (``loop.py:279``),
* ``history.pkl`` is removed at start while ``history.pickle`` is written
  (``loop.py:141-146``),
* the structured ``history.pickle`` is written only when custom callbacks
  are present (``loop.py:147,164``),
* best-val checkpointing is dropped on an empty validation split
  (``loop.py:154-167``),
* the eval history goes to ``save_path/eval_history_batch/``.

``resume`` continues a run from ``model_last_epoch.pt`` and its sidecar,
the port's ``.torch.pt`` or the JAX package's ``.jax.pkl``
(``loop.py:114-139,205-270``); ``checkpoint_every`` spaces the last-epoch
checkpoints.  ``fold_bn_eval`` runs every eval pass with the BatchNorm
statistics folded into the convolutions (:mod:`.fold_bn`).

``data_parallel`` runs the loop as one rank of the default process group
(a one-rank group of its own when there is none:
:func:`~..parallel.join_world`), the counterpart of the JAX package's mesh
over its devices (``loop.py:172-183,324-335``): each pipeline takes the
rank's rows of every batch (:func:`~..data.pipeline.adopt_world`), the
trainer reduces over the world, and rank 0 alone removes the stale files
(then every rank waits), writes the history and the checkpoints; every rank
reads them on ``resume``.  ``model_parallel`` > 1 splits the wide weights
over model groups of that many ranks beside the data groups
(:mod:`..parallel.tensor`); without ``data_parallel`` it is ignored, as
the JAX package builds its mesh only under ``data_parallel``
(``loop.py:174-179,326-331``).

``orbax_dir`` (under ``save_path`` when relative) takes an asynchronous
full-state snapshot at every epoch's end and keeps the newest
``orbax_max_to_keep`` (:class:`~.snapshots.Snapshots`, over
``torch.distributed.checkpoint``; ``loop.py:211-226,283-284``); on
``resume`` the newest snapshot supersedes the ``.pt`` sidecar, and a
fresh run removes the directory's old snapshots as it removes the stale
history.  The loop waits for the last save before it returns, an
exception included.
"""

from __future__ import annotations

import contextlib
import csv
import logging
import os
import pickle
from functools import partial

import numpy as np
import torch

from .. import config as cfg
from .. import parallel
from ..analysis.ondevice_rescale import RESCALE_MEANS_FILENAME, RescaleMeanAccumulator
from ..data.pipeline import adopt_world
from .callbacks import LambdaCallback, ModelCheckpoint
from .framework import Trainer
from .history import append_to_history, save_history
from .snapshots import Snapshots

logger = logging.getLogger(__name__)


def _remove_stale(paths):
    for p in paths:
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


@contextlib.contextmanager
def _data_parallel_world(enabled, device, model_parallel):
    """The :class:`~..parallel.World` the loop runs over when ``enabled``,
    ``model_parallel`` ranks a model group (None otherwise, whatever
    ``model_parallel`` says); a group made for it is destroyed on the way
    out."""
    if not enabled:
        if int(model_parallel) != 1:
            logger.info("model_parallel=%s is ignored without data_parallel, as in the JAX package", model_parallel)
        yield None
        return
    world, made = parallel.join_world(device, int(model_parallel))
    try:
        yield world
    finally:
        parallel.leave_world(made)


def _remove_stale_once(paths, world, device):
    """Rank 0 removes ``paths``, then every rank of ``world`` waits for it."""
    if parallel.is_main_process():
        _remove_stale(paths)
    if world is not None:
        parallel.barrier(device)


def _construct_default_callbacks(H, save_path, checkpoint_monitor, save_with_structure=False, write=True):
    saving = [LambdaCallback(
        on_epoch_end=partial(save_history, save_path=save_path, H=H, save_with_structure=save_with_structure)
    )] if write else []
    return [
        LambdaCallback(on_epoch_end=partial(append_to_history, H=H)),
        *saving,
        ModelCheckpoint(os.path.join(save_path, "model_best_val.pt"), checkpoint_monitor),
        LambdaCallback(on_epoch_end=lambda epoch, logs: logger.info("Saving model from epoch %s", epoch)),
    ]


def _detect_controller(custom_callbacks):
    for clbk in custom_callbacks:
        kind = getattr(clbk, "controller_kind", "none")
        if kind != "none":
            return kind, clbk.controller_config()
    return "none", {}


def _csv_value(text):
    for parse in (int, float):
        try:
            return parse(text)
        except ValueError:
            pass
    return text


def _load_history(save_path) -> dict:
    """A run's history: ``history.pickle`` when there is one (it also holds
    the per-epoch arrays), else the columns of ``history.csv``."""
    pickle_path = os.path.join(save_path, "history.pickle")
    if os.path.exists(pickle_path):
        with open(pickle_path, "rb") as f:
            return pickle.load(f)
    with open(os.path.join(save_path, "history.csv"), newline="") as f:
        rows = list(csv.reader(f))
    return {name: [_csv_value(r[i]) for r in rows[1:]] for i, name in enumerate(rows[0])}


def _resume(trainer, H, callbacks, last_ckpt, steps_per_epoch, checkpoint_monitor, snapshots=None) -> int:
    """Restore the trainer from ``last_ckpt``, then from the newest snapshot
    when ``snapshots`` holds one (it supersedes the sidecar: it is taken
    every epoch, the checkpoint every ``checkpoint_every``), cut the
    history back to the restored epoch (with ``checkpoint_every`` > 1 it
    can be older than the history), set the best-val checkpoint's ``best``
    and replay the history into the callbacks that keep state.  Returns the
    epoch to continue at."""
    trainer.restore(last_ckpt)
    if snapshots is not None:
        epoch = snapshots.restore_latest(trainer)
        if epoch is not None:
            logger.info("Restored the snapshot of epoch %d from %s", epoch, snapshots.directory)
    ckpt_epoch = trainer.step // max(int(steps_per_epoch), 1)
    if H.get("epoch") and ckpt_epoch < int(H["epoch"][-1]):
        logger.info("Checkpoint is at epoch %d, the history at %d: truncating the history to the checkpoint",
                    ckpt_epoch, int(H["epoch"][-1]))
        keep = sum(1 for e in H["epoch"] if int(e) <= ckpt_epoch)
        for key in H:
            del H[key][keep:]
    initial_epoch = (int(H["epoch"][-1]) if H.get("epoch") else ckpt_epoch) + 1
    for clbk in callbacks:
        if isinstance(clbk, ModelCheckpoint) and H.get(checkpoint_monitor):
            clbk.best = max(H[checkpoint_monitor])
        metric = getattr(clbk, "metric", getattr(clbk, "monitor", None))
        if hasattr(clbk, "replay") and metric in H:
            clbk.replay(H[metric])
    logger.info("Resuming from %s at epoch %d", last_ckpt, initial_epoch)
    return initial_epoch


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
    orbax_max_to_keep=2,
    checkpoint_every=1,
    fold_bn_eval=False,
    device="cuda",
    seed=777,
):
    """Train ``model`` (already on ``device``) with ``optimizer``; returns
    the :class:`Trainer`.  ``use_gpu``/``device_numbers`` are accepted for
    the gin surface and ignored.  ``resume`` continues from
    ``model_last_epoch.pt`` when it and ``history.csv`` exist, and starts
    fresh otherwise."""
    with _data_parallel_world(data_parallel, device, model_parallel) as world:
        callbacks = list(custom_callbacks)
        os.makedirs(save_path, exist_ok=True)

        history_csv_path = os.path.join(save_path, "history.csv")
        history_pkl_path = os.path.join(save_path, "history.pkl")
        last_ckpt = os.path.join(save_path, "model_last_epoch.pt")
        resuming = bool(resume) and os.path.exists(last_ckpt) and os.path.exists(history_csv_path)
        if resuming and not any(os.path.exists(f"{last_ckpt}{ext}") for ext in (".torch.pt", ".jax.pkl")):
            raise FileNotFoundError(
                f"training_loop.resume: {last_ckpt}.torch.pt (the port's sidecar) and {last_ckpt}.jax.pkl (the JAX "
                "package's) are both missing"
            )

        H = _load_history(save_path) if resuming else {}
        if not resuming:
            logger.info("Removing %s and %s", history_pkl_path, history_csv_path)
            _remove_stale_once([history_pkl_path, history_csv_path], world, torch.device(device))
        empty_val = not validation_steps or (valid is not None and len(valid) == 0)
        drop_best_val = empty_val and checkpoint_monitor.startswith("val")
        if drop_best_val:
            logger.warning(
                "Empty validation split (validation_steps=%s): %s would be a constant 0.0; best-val "
                "checkpointing is off for this run and only model_last_epoch.pt is written",
                validation_steps, checkpoint_monitor,
            )
        defaults = _construct_default_callbacks(H, save_path, checkpoint_monitor,
                                                save_with_structure=bool(custom_callbacks),
                                                write=parallel.is_main_process())
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
            verbose=verbose and parallel.is_main_process(),
            device=device,
            seed=seed,
            fold_bn_eval=fold_bn_eval,
            world=world,
        )
        if world is not None:
            adopt_world([train, valid, test], world)
        for clbk in callbacks:
            clbk.set_save_path(save_path)
            clbk.set_model(trainer, ignore=False)
            clbk.set_optimizer(optimizer)
            clbk.set_config(config)
            clbk.set_model_pytoune(trainer)

        snapshots = None
        if orbax_dir:
            snapshots = Snapshots(orbax_dir if os.path.isabs(orbax_dir) else os.path.join(save_path, orbax_dir),
                                  max_to_keep=int(orbax_max_to_keep), world=world)
            trainer.snapshots = snapshots
            if not resuming:
                snapshots.clear()  # as the stale history, a fresh run's old snapshots go
        try:
            initial_epoch = 1
            if resuming:
                initial_epoch = _resume(trainer, H, callbacks, last_ckpt, steps_per_epoch, checkpoint_monitor,
                                        snapshots)
            if snapshots is not None:
                callbacks.append(LambdaCallback(on_epoch_end=lambda epoch, logs: snapshots.save(epoch, trainer)))
            every = max(int(checkpoint_every), 1)
            callbacks.append(LambdaCallback(
                on_epoch_end=lambda epoch, logs: trainer.save_weights(last_ckpt) if epoch % every == 0 else None
            ))

            trainer.train_loop(
                train,
                valid_generator=valid,
                test_generator=test,
                test_steps=test_steps,
                validation_steps=validation_steps,
                steps_per_epoch=steps_per_epoch,
                epochs=n_epochs - 1,  # quirk #3 (reference: src/training_loop.py:141)
                callbacks=callbacks,
                initial_epoch=initial_epoch,
            )
        finally:
            if snapshots is not None:
                snapshots.close()
        return trainer


def _construct_default_eval_callbacks(H, save_path, save_with_structure, write=True):
    history_batch = os.path.join(save_path, "eval_history_batch")
    os.makedirs(history_batch, exist_ok=True)
    saving = [LambdaCallback(
        on_epoch_end=partial(save_history, save_path=history_batch, H=H, save_with_structure=save_with_structure)
    )] if write else []
    return [LambdaCallback(on_epoch_end=partial(append_to_history, H=H)), *saving]


@cfg.configurable
def evalution_loop(  # [sic] the reference's name, kept for the gin surface
    model,
    config,
    save_path,
    test=None,
    test_steps=None,
    use_gpu=False,
    device_numbers=(0,),
    custom_callbacks=(),
    pretrained_weights_path=None,
    save_with_structure=False,
    nummodalities=2,
    average_squeezemaps=None,
    mmtm_off=False,
    data_parallel=False,
    model_parallel=1,
    fold_bn_eval=False,
    ondevice_rescale=False,
    ondevice_rescale_training_path=None,
    ondevice_rescale_validation=False,
    device="cuda",
):
    """One test pass of ``model`` (already on ``device``) with the weights of
    ``pretrained_weights_path``, its history in ``save_path/eval_history_batch/``.
    ``ondevice_rescale`` reduces the squeeze maps to their means over the
    training run's train (or val) indices on the device and writes them as
    ``eval_history_batch/rescale_means.pkl`` (``loop.py:350-373,401-428``).
    Returns the :class:`Trainer`."""
    with _data_parallel_world(data_parallel, device, model_parallel) as world:
        trainer = Trainer(
            model,
            nummodalities=nummodalities,
            device=device,
            average_squeezemaps=average_squeezemaps,
            mmtm_off=mmtm_off,
            fold_bn_eval=fold_bn_eval,
            world=world,
        )
        trainer.load_weights(pretrained_weights_path)
        if world is not None:
            adopt_world([test], world)

        selected = None
        if ondevice_rescale:
            # the training run's history.pickle conventionally lives in this
            # save_path: the recording pass runs inside the training directory
            with open(os.path.join(ondevice_rescale_training_path or save_path, "history.pickle"), "rb") as f:
                training_history = pickle.load(f)
            selected = np.asarray(training_history["val_indices" if ondevice_rescale_validation else "train_indices"][0])
            trainer.rescale_accumulator = RescaleMeanAccumulator(selected, trainer.device, world)

        os.makedirs(save_path, exist_ok=True)
        history_batch = os.path.join(save_path, "eval_history_batch")
        stale = [os.path.join(save_path, "eval_history.pkl"), os.path.join(save_path, "eval_history.csv")]
        logger.info("Removing %s and %s", *stale)
        # a means file left by an earlier recording must not stand for this one
        _remove_stale_once(stale + [os.path.join(history_batch, RESCALE_MEANS_FILENAME)], world, trainer.device)

        H = {}
        callbacks = list(custom_callbacks) + _construct_default_eval_callbacks(H, save_path, save_with_structure,
                                                                               write=parallel.is_main_process())
        for clbk in callbacks:
            clbk.set_save_path(save_path)
            clbk.set_model(trainer, ignore=False)
            clbk.set_config(config)
            clbk.set_model_pytoune(trainer)

        trainer.eval_loop(test, epochs=0, test_steps=test_steps, callbacks=callbacks)

        if trainer.rescale_accumulator is not None:
            means, count = trainer.rescale_accumulator.means()  # on every rank: it sums over the world
            if parallel.is_main_process():
                out_path = os.path.join(history_batch, RESCALE_MEANS_FILENAME)
                with open(out_path, "wb") as f:
                    pickle.dump({
                        "key": "test_squeezedmaps_array_list",
                        "validation": bool(ondevice_rescale_validation),
                        "means": means,
                        "count": count,
                        # the index set the means were taken over: get_rescale_weights
                        # takes them only when its own selection is the same
                        "selected": np.asarray(selected, np.int64),
                    }, f)
                logger.info("on-device rescale means written to %s (%d member samples)", out_path, count)
        return trainer
