"""Callbacks (``greedy_multimodal_learning_tpu/engine/callbacks.py``): the
hook set, the four balancing controllers' callbacks (guided, random,
weakest, adaptive-weakest), stopping, the learning-rate plateau,
checkpointing and progress lines, with the JAX package's gin names.

The controllers' arithmetic runs inside the train step
(``engine/controller.py``); each callback carries its configuration and
unlocks the controller at ``starting_epoch``, and the weakest controllers'
callbacks designate the target after each epoch.  On resume,
``training_loop`` replays the history into the stopping and plateau
callbacks (``replay``) and sets the best-val checkpoint's ``best``; the
controller state, designated target included, comes back from the sidecar.
"""

from __future__ import annotations

import itertools
import logging
import sys
import timeit

import numpy as np
import torch

from .. import config as cfg

logger = logging.getLogger(__name__)


def _host_float(v):
    """float(v) for progress rendering, skipping values still on a device:
    reading one would wait for the step, and the epoch-end line shows the
    fetched values anyway."""
    if v is None or (isinstance(v, torch.Tensor) and v.device.type != "cpu"):
        return None
    return float(v)


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, callback):
        self.callbacks.append(callback)

    def _each(self, hook, *args):
        for c in self.callbacks:
            getattr(c, hook)(*args)

    def set_params(self, params):
        self._each("set_params", params)

    def set_model_pytoune(self, model_pytoune):
        self._each("set_model_pytoune", model_pytoune)

    def on_epoch_begin(self, epoch, logs=None):
        self._each("on_epoch_begin", epoch, logs or {})

    def on_epoch_end(self, epoch, logs=None):
        self._each("on_epoch_end", epoch, logs or {})

    def on_batch_begin(self, batch, logs=None):
        self._each("on_batch_begin", batch, logs or {})

    def on_batch_end(self, batch, logs=None):
        self._each("on_batch_end", batch, logs or {})

    def on_forward_begin(self, batch, data):
        self._each("on_forward_begin", batch, data)

    def on_backward_end(self, batch):
        self._each("on_backward_end", batch)

    def on_train_begin(self, logs=None):
        self._each("on_train_begin", logs or {})

    def on_train_end(self, logs=None):
        self._each("on_train_end", logs or {})

    def on_val_batch_end(self, batch, logs=None):
        self._each("on_val_batch_end", batch, logs or {})


class Callback:
    def set_config(self, config):
        self.config = config

    def set_save_path(self, save_path):
        self.save_path = save_path

    def set_optimizer(self, optimizer):
        self.optimizer = optimizer

    def set_model(self, model, ignore=True):
        if not ignore:
            self.model = model

    def set_model_pytoune(self, model_pytoune):
        self.model_pytoune = model_pytoune

    def set_params(self, params):
        self.params = params

    def on_epoch_begin(self, epoch, logs):
        pass

    def on_epoch_end(self, epoch, logs):
        pass

    def on_batch_begin(self, batch, logs):
        pass

    def on_batch_end(self, batch, logs):
        pass

    def on_forward_begin(self, batch, data):
        pass

    def on_backward_end(self, batch):
        pass

    def on_train_begin(self, logs):
        pass

    def on_train_end(self, logs):
        pass

    def on_val_batch_end(self, batch, logs):
        pass


class _BalancingController(Callback):
    """A controller's callback: names its kind and configuration for the
    trainer, resets the controller at train begin (a resume keeps the
    restored state) and unlocks it at ``starting_epoch``."""

    controller_kind = "none"
    starting_epoch = 1

    def controller_config(self):
        return {}

    def on_train_begin(self, logs):
        self.model_pytoune.reset_controller()

    def on_epoch_begin(self, epoch, logs):
        if epoch >= self.starting_epoch:
            self.model_pytoune.unlock_controller()


@cfg.configurable
class Bias_Mitigation_Strong(_BalancingController):
    """Guided balancing (the paper's algorithm), ``callbacks.py:201-233``."""

    controller_kind = "guided"

    def __init__(
        self,
        epsilon=0.01,
        curation_windowsize=5,
        branchnames=("net_view_0", "net_view_1"),
        starting_epoch=2,
        MMTMnames=("visual", "skeleton"),
    ):
        self.epsilon = epsilon
        self.curation_windowsize = curation_windowsize
        self.branchnames = list(branchnames)
        self.MMTMnames = list(MMTMnames)
        self.starting_epoch = starting_epoch

    def controller_config(self):
        return dict(
            epsilon=self.epsilon,
            curation_windowsize=self.curation_windowsize,
            branchnames=self.branchnames,
            mmtm_names=self.MMTMnames,
            starting_epoch=self.starting_epoch,
        )


@cfg.configurable
class Bias_Mitigation_Random(_BalancingController):
    """The random-curation ablation (``callbacks.py:236-252``): each
    unlocked step curates no modality, modality 1 or modality 0, uniformly
    (:func:`~.controller.random_update`)."""

    controller_kind = "random"

    def __init__(self, starting_epoch=2):
        self.starting_epoch = starting_epoch

    def controller_config(self):
        return dict(starting_epoch=self.starting_epoch)


def _check_monitor(monitor):
    if monitor not in ("val", "train"):
        raise ValueError(f"monitor must be 'val' or 'train', got {monitor!r}")


class _WeakestTarget(_BalancingController):
    """The weakest controllers' host side: the target starts undesignated
    (-1) unless a resume restored it, and each epoch's end reads the
    per-modality accuracies, of the validation split with ``monitor='val'``
    when the logs have them, else of the train split."""

    def on_train_begin(self, logs):
        resumed = self.model_pytoune._skip_next_controller_reset
        super().on_train_begin(logs)
        if not resumed:
            self.model_pytoune.set_controller_target(-1)

    def _modal_accs(self, logs):
        """The per-modality accuracies, or None when the logs lack one."""
        prefix = "val_" if self.monitor == "val" and "val_acc_modal_0" in logs else ""
        accs = [logs.get(f"{prefix}acc_modal_{i}") for i in range(self.model_pytoune.nummodalities)]
        return None if any(a is None for a in accs) else accs


@cfg.configurable
class Bias_Mitigation_Weakest(_WeakestTarget):
    """Weakest-modality curation (``callbacks.py:255-330``; the JAX
    package's extension, no reference counterpart): after each epoch the
    modality with the lowest per-modality accuracy becomes the target, and
    the device curates it ``curation_windowsize`` of every ``duty_period``
    unlocked steps (:func:`~.controller.weakest_update`)."""

    controller_kind = "weakest"

    def __init__(
        self,
        epsilon=0.0,  # accepted for the gin surface; unused
        curation_windowsize=5,
        duty_period=10,
        starting_epoch=2,
        branchnames=("net_view_0", "net_view_1"),
        MMTMnames=("visual", "skeleton"),
        monitor="val",
    ):
        if duty_period < 1 or curation_windowsize < 1:
            raise ValueError("duty_period and curation_windowsize must be >= 1")
        if curation_windowsize >= duty_period:
            raise ValueError(
                f"curation_windowsize ({curation_windowsize}) must be smaller than duty_period ({duty_period}) "
                "— equal or larger would curate every unlocked step"
            )
        _check_monitor(monitor)
        self.curation_windowsize = curation_windowsize
        self.duty_period = duty_period
        self.starting_epoch = starting_epoch
        self.branchnames = list(branchnames)
        self.MMTMnames = list(MMTMnames)
        self.monitor = monitor

    def controller_config(self):
        return dict(
            curation_windowsize=self.curation_windowsize,
            duty_period=self.duty_period,
            branchnames=self.branchnames,
            mmtm_names=self.MMTMnames,
            starting_epoch=self.starting_epoch,
        )

    def on_epoch_end(self, epoch, logs):
        accs = self._modal_accs(logs)
        if accs is not None:
            self.model_pytoune.set_controller_target(int(np.argmin(accs)))


@cfg.configurable
class Bias_Mitigation_AdaptiveWeakest(_WeakestTarget):
    """Weakest-modality targeting with a gap-gated trigger
    (``callbacks.py:333-407``; the JAX package's extension): after each
    epoch the weakest modality becomes the target only while its accuracy
    trails the others' mean by more than ``min_gap`` points (else -1), and
    the device curates it in guided-style windows
    (:func:`~.controller.adaptive_weakest_update`)."""

    controller_kind = "adaptive_weakest"

    def __init__(
        self,
        curation_windowsize=5,
        min_gap=5.0,
        starting_epoch=2,
        branchnames=("net_view_0", "net_view_1"),
        MMTMnames=("visual", "skeleton"),
        monitor="val",
    ):
        if curation_windowsize < 1:
            raise ValueError("curation_windowsize must be >= 1")
        if min_gap < 0:
            raise ValueError("min_gap must be >= 0 (accuracy points)")
        _check_monitor(monitor)
        self.curation_windowsize = curation_windowsize
        self.min_gap = min_gap
        self.starting_epoch = starting_epoch
        self.branchnames = list(branchnames)
        self.MMTMnames = list(MMTMnames)
        self.monitor = monitor

    def controller_config(self):
        return dict(
            curation_windowsize=self.curation_windowsize,
            branchnames=self.branchnames,
            mmtm_names=self.MMTMnames,
            starting_epoch=self.starting_epoch,
        )

    def on_epoch_end(self, epoch, logs):
        accs = self._modal_accs(logs)
        if accs is None:
            return
        n = len(accs)
        weakest = int(np.argmin(accs))
        gap = (sum(accs) - accs[weakest]) / (n - 1) - accs[weakest]
        self.model_pytoune.set_controller_target(weakest if gap > self.min_gap else -1)


@cfg.configurable
class CompletedStopping(Callback):
    """Stop when the monitored metric is exactly 100 for ``patience`` epochs,
    counted cumulatively (``callbacks.py:410-440``)."""

    def __init__(self, *, monitor="acc", patience=5, verbose=True):
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.stopped_epoch = 0

    def on_train_begin(self, logs):
        self.stopped_epoch = 0
        self.counter = getattr(self, "_replayed_counter", 0)

    def replay(self, history_values):
        """The counter from earlier epochs' values (``callbacks.py:425``)."""
        self._replayed_counter = sum(1 for v in history_values if v == 100)

    def on_epoch_end(self, epoch, logs):
        if logs[self.monitor] == 100:
            self.counter += 1
        if self.counter >= self.patience:
            self.stopped_epoch = epoch
            self.model_pytoune.stop_training = True

    def on_train_end(self, logs):
        if self.stopped_epoch > 0 and self.verbose:
            print("Epoch %05d: completed stopping" % (self.stopped_epoch + 1))


@cfg.configurable
class ReduceLROnPlateau_PyTorch(Callback):
    """``torch.optim.lr_scheduler.ReduceLROnPlateau`` semantics on an epoch
    metric: mode min, relative threshold 1e-3, cooldown 0, min_lr 1e-6,
    eps 1e-8 (``callbacks.py:444-490``)."""

    def __init__(self, metric="loss", factor=0.3, patience=10):
        self.metric = metric
        self.factor = factor
        self.patience = patience
        self.threshold = 1e-3
        self.min_lr = 1e-6
        self.eps = 1e-8

    def on_train_begin(self, logs):
        self.best = getattr(self, "_replayed_best", float("inf"))
        self.num_bad_epochs = getattr(self, "_replayed_bad", 0)

    def replay(self, history_values):
        """``best`` and the bad-epoch count from earlier epochs' values
        (``callbacks.py:461``); the learning rate itself comes back with the
        optimizer state."""
        best, bad = float("inf"), 0
        for v in history_values:
            v = float(v)
            if v < best * (1.0 - self.threshold):
                best, bad = v, 0
            else:
                bad += 1
                if bad > self.patience:
                    bad = 0
        self._replayed_best, self._replayed_bad = best, bad

    def on_epoch_end(self, epoch, logs):
        current = float(logs[self.metric])
        if current < self.best * (1.0 - self.threshold):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            old_lr = self.model_pytoune.get_lr()
            new_lr = max(old_lr * self.factor, self.min_lr)
            if old_lr - new_lr > self.eps:
                self.model_pytoune.set_lr(new_lr)
                print(f"Epoch {epoch:5d}: reducing learning rate to {new_lr:.4e}.")
            self.num_bad_epochs = 0


class LambdaCallback(Callback):
    def __init__(self, on_epoch_end):
        self.on_epoch_end = on_epoch_end


class ModelCheckpoint(Callback):
    """Save when the monitored epoch metric exceeds its best so far: the
    best-val checkpoint of ``training_loop``, whose ``ModelCheckpoint``
    (``callbacks.py:511-567``) runs with ``save_best_only=True`` and mode
    max whatever the metric (reference ``src/training_loop.py:39-42``)."""

    def __init__(self, filepath, monitor):
        self.filepath = filepath
        self.monitor = monitor
        self.best = -np.inf

    def on_epoch_end(self, epoch, logs):
        current = logs.get(self.monitor)
        if current is None:
            logging.warning("Can save best model only with %s available, skipping.", self.monitor)
        elif current > self.best:
            self.best = current
            self.model_pytoune.save_weights(self.filepath)


def _metric_strings(logs, keys):
    out = []
    for k in keys:
        v = _host_float(logs.get(k))
        if v is not None:
            out.append("{}: {:f}".format(k, v))
    return out


@cfg.configurable
class ProgressionCallback(Callback):
    """Carriage-return progress lines with an ETA (``callbacks.py:571-647``),
    at most one every ``min_render_interval`` seconds."""

    def __init__(self, other_metrics=("acc_modal_0", "acc_modal_1"), min_render_interval=2.0):
        self.other_metrics = list(other_metrics)
        self.min_render_interval = min_render_interval
        self._last_render = 0.0

    def on_train_begin(self, logs):
        self.metrics = ["loss"] + self.model_pytoune.metrics_names
        self.epochs = self.params["epochs"]
        self.steps = self.params["steps"]

    def on_epoch_begin(self, epoch, logs):
        self.step_times_sum = 0.0
        self.epoch = epoch
        sys.stdout.write("\rEpoch %d/%d" % (self.epoch, self.epochs))
        sys.stdout.flush()

    def _line(self, logs):
        metrics = ", ".join(itertools.chain(
            _metric_strings(logs, self.metrics), _metric_strings(logs, ["val_" + k for k in self.metrics])))
        return metrics, ", ".join(_metric_strings(logs, self.other_metrics))

    def on_epoch_end(self, epoch, logs):
        metrics, other = self._line(logs)
        steps = self.steps or 0
        print("\rEpoch %d/%d %.2fs: Step %d/%d: %s. %s"
              % (self.epoch, self.epochs, logs.get("time", 0.0), steps, steps, metrics, other))

    def on_batch_end(self, batch, logs):
        self.step_times_sum += timeit.default_timer() - logs.get("batch_begin_time", timeit.default_timer())
        now = timeit.default_timer()
        if self.steps is not None and batch < self.steps and now - self._last_render < self.min_render_interval:
            return
        self._last_render = now
        metrics, other = self._line(logs)
        times_mean = self.step_times_sum / max(batch, 1)
        if self.steps is not None:
            sys.stdout.write("\rEpoch %d/%d ETA %.2fs Step %d/%d: %s. %s" % (
                self.epoch, self.epochs, times_mean * (self.steps - batch), batch, self.steps, metrics, other))
        else:
            sys.stdout.write("\rEpoch %d/%d %.2fs/step Step %d: %s. %s"
                             % (self.epoch, self.epochs, times_mean, batch, metrics, other))
        sys.stdout.flush()


class ValidationProgressionCallback(Callback):
    """Per-phase eval progress lines (``callbacks.py:650-691``)."""

    def __init__(self, phase, metrics_names, steps=None, min_render_interval=2.0):
        self.params = {"steps": steps, "phase": phase}
        self.metrics = metrics_names
        self.min_render_interval = min_render_interval
        self._last_render = 0.0
        self.step_times_sum = 0.0

    def on_batch_begin(self, batch, logs):
        if batch == 1:
            self.step_times_sum = 0.0
        self.steps = self.params["steps"]

    def on_batch_end(self, batch, logs):
        self.step_times_sum += timeit.default_timer() - logs.get("batch_begin_time", timeit.default_timer())
        now = timeit.default_timer()
        if self.steps is not None and batch < self.steps and now - self._last_render < self.min_render_interval:
            return
        self._last_render = now
        phase = self.params["phase"]
        metrics = ", ".join(
            f"{phase}_{k}: {v:f}" for k in self.metrics if (v := _host_float(logs.get(k))) is not None
        )
        times_mean = self.step_times_sum / max(batch, 1)
        if self.steps is not None:
            sys.stdout.write("\r%s ETA %.2fs Step %d/%d: %s."
                             % (phase, times_mean * (self.steps - batch), batch, self.steps, metrics))
        else:
            sys.stdout.write("\r%s %.2fs/step Step %d: %s." % (phase, times_mean, batch, metrics))
        sys.stdout.flush()
