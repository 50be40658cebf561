"""Trainer: the engine around the model (``greedy_multimodal_learning_tpu/engine/framework.py``).

The epoch loop (train, then validation and test passes), the eval loop,
size-weighted epoch metrics, callback hooks and the NaN stop, plus serving
(``predict``).  Step outputs stay on the device and are fetched once per
pass; a NaN loss stops training after the epoch, as in the JAX package.
The controller state lives on the device and enters each step as tensors;
callbacks flip host latches (``unlock_controller``) and write the weakest
controllers' target on the device (``set_controller_target``).  Batches
come as host numpy arrays (streamed) or as tensors already on the device
(``DeviceCachePipeline``), which pass through without a copy.

A trainer built with ``mmtm_off`` runs every eval and predict forward with
the cross-modal flow cut (``average_squeezemaps``, turned into device
tensors once).  With the model's saving flags on, each pass adds the
recorded scales and squeeze maps, per batch, MMTM and view, trimmed to the
batch's real rows (``framework.py:270-282,539-568``); a
``rescale_accumulator`` takes the squeeze maps on the device instead.

A trainer built with ``fold_bn_eval`` folds the BatchNorm statistics into
the convolutions once an eval pass and runs that pass's forwards on the
folded tensors through ``torch.func.functional_call``; training never sees
them (``framework.py:110-119,285-313,347-360``).  ``enable_profiling``
traces the next train epoch with ``torch.profiler``
(``framework.py:169-171,220-254``).

A trainer built with a ``world`` (:class:`~..parallel.World`) is one rank
of a data-parallel run, the counterpart of the JAX trainer's ``mesh``
(``framework.py:85-98``): each batch holds its data index's rows of the
node batch (:func:`~..data.pipeline.adopt_world`), its steps reduce over
the data group (:mod:`..parallel.mesh`), the flips are the data index's
rows of the global batch's draw, the epoch metrics are weighted by the
global batch sizes, the recordings and indices are gathered in
global-batch order, and rank 0 alone writes checkpoints.  The model's
state starts as rank 0's.  With ``world.model_size`` > 1 each rank then
keeps its rows of the weights the JAX rule selects
(``model_parallel_min_dim``, :mod:`..parallel.tensor`); checkpoints, loads
and BatchNorm folding see them whole.

Not ported: the scanned eval (it served the TPU's remote link).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import timeit
from typing import Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from ..data.transforms import draw_flips, flip_shape, preprocess
from ..parallel import mesh as parallel
from ..parallel import tensor as tensor_parallel
from ..parallel.multihost import is_main_process
from ..utils import prng
from .bdr import GroupReducer
from .callbacks import CallbackList, ProgressionCallback, ValidationProgressionCallback
from .controller import ControllerState, controller_key, init_controller_state, key_array, key_tensor
from .fold_bn import fold_batchnorm
from .steps import RECORD_KEYS, eval_step, make_controller_update, train_step
from .train_state import get_learning_rate, set_learning_rate, train_keys

logger = logging.getLogger(__name__)


def _cycle(iterable):
    while True:
        for x in iterable:
            yield x


def _steps(generator, steps):
    """(1-based index, batch) pairs: ``steps`` batches cycling the generator,
    or one pass over it when ``steps`` is None."""
    if steps is None:
        return enumerate(generator, 1)
    return zip(range(1, steps + 1), _cycle(generator))


def _fetch(records):
    """One device-to-host copy for a list of {name: 0-dim or (N,) tensor}."""
    if not records:
        return []
    keys = list(records[0])
    flat = torch.cat([torch.cat([r[k].float().reshape(-1) for k in keys]) for r in records]).cpu().numpy()
    widths = [records[0][k].numel() for k in keys]
    out, offset = [], 0
    for _ in records:
        row = {}
        for k, w in zip(keys, widths):
            row[k] = flat[offset] if records[0][k].dim() == 0 else flat[offset:offset + w]
            offset += w
        out.append(row)
    return out


def _fetch_records(per_batch, sizes):
    """One device-to-host copy for per-batch {key: [MMTM][view] (B, C)
    tensor} recordings, each batch trimmed to its ``size`` real rows on the
    device; returns {key: [batch][MMTM][view] numpy (size, C)}."""
    if not per_batch or not per_batch[0]:
        return {}
    keys = list(per_batch[0])
    leaves = [t[:size].reshape(-1) for rec, size in zip(per_batch, sizes) for k in keys for m in rec[k] for t in m]
    flat = torch.cat(leaves).cpu().numpy()
    out, offset = {k: [] for k in keys}, 0
    for rec, size in zip(per_batch, sizes):
        for k in keys:
            batch = []
            for m in rec[k]:
                views = []
                for t in m:
                    n = size * t.shape[1]
                    views.append(flat[offset:offset + n].reshape(size, t.shape[1]))
                    offset += n
                batch.append(views)
            out[k].append(batch)
    return out


def _on_device(value, device) -> torch.Tensor:
    """A batch entry as a tensor on ``device``: a tensor already there passes
    through without a copy; a host numpy array is copied."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(value)
    return value.to(device, non_blocking=True)


def _device_maps(average_squeezemaps, device):
    """The analysis pipeline's 4-slot maps (None or a list of per-view
    arrays a slot) as float32 tensors on ``device``."""
    if average_squeezemaps is None:
        return None
    return [None if slot is None else [torch.as_tensor(np.asarray(v), dtype=torch.float32).to(device) for v in slot]
            for slot in average_squeezemaps]


class _FoldedModel:
    """``model`` called with ``tensors`` in place of its own parameters and
    buffers of those names (``torch.func.functional_call``); every other
    attribute is the model's."""

    def __init__(self, model, tensors):
        self.model = model
        self.tensors = tensors

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.model, self.tensors, args, kwargs)

    def __getattr__(self, name):
        return getattr(self.model, name)


class Trainer:
    def __init__(
        self,
        model,
        optimizer=None,
        *,
        controller_kind: str = "none",
        controller_config: Optional[dict] = None,
        nummodalities: int = 2,
        verbose: bool = True,
        device="cuda",
        seed: int = 777,
        average_squeezemaps=None,
        mmtm_off: bool = False,
        fold_bn_eval: bool = False,
        world: Optional[parallel.World] = None,
        model_parallel_min_dim: int = 256,
    ):
        self.model = model
        self.world = world
        self.model_parallel_min_dim = int(model_parallel_min_dim)
        self.optimizer = optimizer
        self.nummodalities = nummodalities
        self.device = torch.device(device)
        self.metrics_names = ["acc"]
        self.verbose = verbose
        self.stop_training = False
        self.controller_kind = controller_kind
        self.controller_config = controller_config or {}
        self._seed = int(seed)
        # the JAX package's keys of train.seed: the controller's
        # (``controller.py:58``, carried in the state) and the data key the
        # train flips fold the step into (``train_state.py:57``)
        self.ctrl = init_controller_state(nummodalities, self.device, self._seed)
        self.data_key = train_keys(self._seed)[1]
        self._unlock = False
        self.step = 0
        self.curated_steps = 0
        self.mmtm_off = bool(mmtm_off)
        self.average_squeezemaps = _device_maps(average_squeezemaps, self.device)
        if self.mmtm_off and self.average_squeezemaps is None:
            raise ValueError("mmtm_off needs average_squeezemaps (analysis.get_rescale_weights)")
        # analysis.ondevice_rescale.RescaleMeanAccumulator: takes the eval
        # passes' squeeze maps on the device instead of the history
        self.rescale_accumulator = None
        self.fold_bn_eval = bool(fold_bn_eval)
        self.profile_dir = None  # enable_profiling: the next train epoch's trace goes here
        self.snapshots = None  # training_loop's engine.snapshots.Snapshots under orbax_dir
        self._skip_next_controller_reset = False
        if optimizer is None:
            return
        if controller_kind not in ("none", "guided", "random", "weakest", "adaptive_weakest"):
            raise ValueError(f"unknown controller kind {controller_kind!r}")
        branchnames = self.controller_config.get("branchnames") or [f"net_view_{i}" for i in range(nummodalities)]
        mmtm_names = self.controller_config.get("mmtm_names") or list(model.modality_names)
        self._reducer = GroupReducer([n for n, _ in model.named_parameters()], branchnames, mmtm_names)
        if controller_kind in ("guided", "weakest", "adaptive_weakest") and self._reducer.empty_groups:
            # an empty group makes its BDR ratio 0/0: curation (guided) or the
            # d_BDR telemetry (weakest) would be NaN for the whole run
            raise ValueError(
                f"{controller_kind} controller: no parameters matched group(s) {self._reducer.empty_groups}; "
                "check branchnames/mmtm_names against the parameter names"
            )
        self._controller_update = make_controller_update(
            controller_kind, nummodalities,
            **{k: v for k, v in self.controller_config.items() if k in ("epsilon", "curation_windowsize", "duty_period")},
        )

    def enable_profiling(self, trace_dir: str):
        """Trace the next train epoch (CPU and, on a card, CUDA activity)
        into one Chrome trace in ``trace_dir``; one epoch a call."""
        self.profile_dir = trace_dir

    # --- handles used by callbacks ---

    def reset_controller(self):
        if self._skip_next_controller_reset:
            # a resume has just restored the controller from the sidecar
            self._skip_next_controller_reset = False
            return
        # the carried key survives the reset (``framework.py:180-186``)
        self.ctrl = dataclasses.replace(init_controller_state(self.nummodalities, self.device), rng=self.ctrl.rng)
        self._unlock = False

    def unlock_controller(self):
        self._unlock = True

    def set_controller_target(self, modality: int):
        """The weakest controllers' host-designated target, written into
        ``caring_modality`` on the device (-1: none).  A fill on the device,
        unconditional: reading the flag first would wait for the step."""
        self.ctrl = dataclasses.replace(self.ctrl, caring_modality=torch.full(
            (), int(modality), dtype=self.ctrl.caring_modality.dtype, device=self.device))

    def get_lr(self):
        return get_learning_rate(self.optimizer)

    def set_lr(self, lr):
        set_learning_rate(self.optimizer, lr)

    def save_weights(self, filepath):
        """The checkpoint and its sidecar, the weights and momentum whole;
        under data parallelism rank 0 writes them and every rank waits until
        it has."""
        with tensor_parallel.unsharded(self.model, self.optimizer):
            if is_main_process():
                ckpt.save_weights(self.model, filepath, optimizer=self.optimizer, controller=self.ctrl.as_dict(),
                                  step=self.step, rng=key_tensor(self.data_key))
        if self.world is not None:
            parallel.barrier(self.device)

    def load_weights(self, filepath):
        """A checkpoint of whole weights; a sharded model keeps its rows."""
        with tensor_parallel.unsharded(self.model):
            ckpt.load_weights(self.model, filepath)

    def distribute(self):
        """Under data parallelism every rank takes rank 0's state, then
        under tensor parallelism keeps its rows of the selected weights and
        their momentum (:meth:`_take_shards`).  A model that holds its rows
        already is left as it is."""
        if self.world is None or tensor_parallel.is_sharded(self.model):
            return
        parallel.broadcast_module_(self.model)
        self._take_shards()

    def _take_shards(self):
        """Under tensor parallelism, this rank's rows of the selected weights
        and their momentum (once)."""
        if self.world is not None and not tensor_parallel.is_sharded(self.model):
            names = tensor_parallel.shard_module_(self.model, self.world, self.model_parallel_min_dim, self.optimizer)
            if names:
                logger.info("tensor parallelism: %d weights split %d ways (model index %d)", len(names),
                            self.world.model_size, self.world.model_index)

    def restore(self, filepath):
        """Resume from ``filepath`` and its sidecar, the port's ``.torch.pt``
        or the JAX package's ``.jax.pkl``
        (:func:`~.checkpoint.load_training_state`): parameters, BatchNorm
        statistics, MMTM buffers, optimizer state, controller state with
        its key, step and data key; the next train-begin controller reset
        is skipped (``framework.py:174-179``)."""
        with tensor_parallel.unsharded(self.model, self.optimizer):
            state = ckpt.load_training_state(self.model, self.optimizer, filepath)
        self.set_run_state(state["controller"], state["step"], state.get("rng"), filepath)

    def set_run_state(self, controller: dict, step: int, data_key=None, source="the checkpoint"):
        """The controller state (a dict of its fields), the step and the data
        key of a resume; the next train-begin controller reset is skipped.
        A state written before the port carried the keys holds neither: the
        data key is then the seed's, the controller's key the one a run of
        this trainer's controller kind reaches after ``step`` steps
        (:func:`~.controller.controller_key`, exact when the run kept one
        controller kind)."""
        self.step = int(step)
        controller = dict(controller)
        if controller.get("rng") is None:
            controller["rng"] = controller_key(self._seed, self.controller_kind, self.step)
            logger.info("%s holds no controller key: re-derived from train.seed=%d for a %s controller at step %d",
                        source, self._seed, self.controller_kind, self.step)
        if data_key is None:
            data_key = train_keys(self._seed)[1]
            logger.info("%s holds no data key: re-derived from train.seed=%d", source, self._seed)
        self.ctrl = ControllerState(**{k: v if k == "rng" else v.to(self.device) for k, v in controller.items()})
        self.data_key = key_array(key_tensor(data_key))
        self._skip_next_controller_reset = True

    # --- epoch loops ---

    def _to_device(self, batch):
        return {k: _on_device(batch[k], self.device) for k in ("images", "labels", "mask")}

    def _block_indices(self, batch) -> np.ndarray:
        """This rank's rows of the batch's ``indices`` (-1 on padding); a
        batch without ``rows`` raises, as its images would be the whole node
        batch's."""
        if "rows" not in batch:
            raise ValueError("a data-parallel trainer takes batches of its rank's rows: adopt_world(pipelines, world)")
        return np.asarray(batch["indices"])[batch["rows"]]

    def train_flips(self, *shape: int) -> torch.Tensor:
        """The flips of the next train step, of ``shape`` ((B, V) for image
        stacks, (B,) for clips: :func:`~..data.transforms.flip_shape`): the
        JAX package's ``bernoulli(fold_in(data_key, step), 0.5, shape)``
        (``steps.py:88``), drawn on the host and copied to the device without
        a wait.  Under data parallelism ``shape`` is the rank's block: the
        global batch's flips are drawn and the rank takes its data index's
        rows, as the ranks of its model group do."""
        key = prng.fold_in(self.data_key, self.step)
        if self.world is None:
            flips = draw_flips(shape, key)
        else:
            b, d = shape[0], self.world.data_index
            flips = draw_flips((b * self.world.data_size,) + tuple(shape[1:]), key)[d * b:(d + 1) * b]
        if self.device.type == "cuda":
            flips = flips.pin_memory()  # a copy from pageable memory would wait
        return flips.to(self.device, non_blocking=True)

    def train_batch(self, data, flips, unlock) -> dict:
        """One train step on a batch of device tensors with its
        ``flips`` and the () bool ``unlock``; advances the controller state
        and the step count.  Returns the step's device outputs."""
        with parallel.data_parallel(self.world):
            self.ctrl, out = train_step(
                self.model, self.optimizer, self._reducer, self._controller_update, self.ctrl, data, flips, unlock
            )
        self.step += 1
        return out

    def _pass_records(self, indices, sizes, recorded):
        """(indices, sizes, recordings as {key: [batch][MMTM][view] numpy
        (size, C)}) of a pass, fetched in one copy; under data parallelism
        the global batches' (:meth:`_gather_pass`)."""
        if self.world is None:
            return indices, sizes, _fetch_records(recorded, sizes)
        indices, recorded = self._gather_pass(indices, recorded)
        return indices, [len(i) for i in indices], recorded

    def _gather_pass(self, blocks, recorded):
        """Under data parallelism: the pass's indices and recordings in
        global-batch order (the ranks' blocks joined) and trimmed to the
        real rows, from ``blocks`` (each batch's rows of ``indices``) and
        ``recorded`` (each batch's {key: [MMTM][view] (b, C)} tensors); one
        gather each over the data group.  Returns ([batch] indices,
        {key: [batch][MMTM][view] numpy (size, C)})."""
        if not blocks:
            return [], {}
        world = self.world
        local = torch.from_numpy(np.stack(blocks).astype(np.int64)).to(self.device)
        joined = parallel.gather(local, world).cpu().numpy()  # (data indices, batches, b)
        per_batch = [joined[:, k].reshape(-1) for k in range(len(blocks))]
        valid = [idx != -1 for idx in per_batch]
        indices = [idx[v].astype(blocks[0].dtype) for idx, v in zip(per_batch, valid)]
        if not recorded[0]:
            return indices, {}
        keys = list(recorded[0])
        leaves = [t.reshape(-1) for rec in recorded for k in keys for m in rec[k] for t in m]
        flat = parallel.gather(torch.cat(leaves), world).cpu().numpy()  # (data indices, leaf floats)
        out, offset = {k: [] for k in keys}, 0
        for rec, v in zip(recorded, valid):
            for k in keys:
                batch = []
                for m in rec[k]:
                    views = []
                    for t in m:
                        n = t.numel()
                        views.append(flat[:, offset:offset + n].reshape(-1, t.shape[1])[v])
                        offset += n
                    batch.append(views)
                out[k].append(batch)
        return indices, out

    def _start_profiler(self):
        """A started ``torch.profiler`` when ``enable_profiling`` asked for
        this epoch, else None."""
        if not self.profile_dir:
            return None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, first_step):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"train_steps_{first_step}-{self.step - 1}.trace.json")
        profiler.export_chrome_trace(path)
        logger.info("Train epoch traced to %s", path)
        self.profile_dir = None

    def _train_epoch(self, generator, steps_per_epoch, callback_list):
        records, recorded, sizes, indices = [], [], [], []
        unlock = torch.tensor(self._unlock, device=self.device)
        profiler, first_step = self._start_profiler(), self.step
        for batch_ind, batch in _steps(generator, steps_per_epoch):
            batch_begin_time = timeit.default_timer()
            callback_list.on_batch_begin(batch_ind, {})
            callback_list.on_forward_begin(batch_ind, batch)
            size = batch["size"]
            data = self._to_device(batch)
            out = self.train_batch(data, self.train_flips(*flip_shape(data["images"].shape)), unlock)
            callback_list.on_backward_end(batch_ind)
            recorded.append({k: out.pop(k) for k in RECORD_KEYS if k in out})
            records.append(out)
            sizes.append(size)
            indices.append(np.asarray(batch["indices"])[:size] if self.world is None else self._block_indices(batch))
            batch_logs = {
                "batch": batch_ind,
                "size": size,
                "time": timeit.default_timer() - batch_begin_time,
                "batch_begin_time": batch_begin_time,
                **{k: out[k] for k in ("loss", "acc", "d_BDR", "curation_mode", "caring_modality")},
            }
            for i in range(self.nummodalities):
                batch_logs[f"acc_modal_{i}"] = out["acc_modal"][i]
            callback_list.on_batch_end(batch_ind, batch_logs)

        if profiler is not None:
            self._stop_profiler(profiler, first_step)
        outs = _fetch(records)  # the epoch's one synchronization point
        self.curated_steps += int(sum(bool(o["curated"]) for o in outs))
        indices, sizes, recorded = self._pass_records(indices, sizes, recorded)
        sizes = np.array(sizes, np.float64)
        losses = np.array([o["loss"] for o in outs], np.float64)
        total = sizes.sum()
        train_dict = {
            "loss": float((losses * sizes).sum() / total),
            "train_indices": np.concatenate(indices) if indices else [],
            "acc": float((np.array([o["acc"] for o in outs]) * sizes).sum() / total),
            "_num_samples": float(total),
        }
        for i in range(self.nummodalities):
            vals = np.array([o["acc_modal"][i] for o in outs])
            train_dict[f"acc_modal_{i}"] = float((vals * sizes).sum() / total)
        for key, per_batch in recorded.items():
            train_dict[f"train_{key}"] = per_batch
        if np.isnan(losses).any():
            self.stop_training = True
        return train_dict

    def _eval_model(self):
        """The model an eval pass runs: with ``fold_bn_eval``, the model on
        its BatchNorm statistics folded into the convolutions, folded once
        for the pass (the folded entries only; the MMTM buffers stay the
        model's own and take the pass's updates)."""
        if not self.fold_bn_eval:
            return self.model
        with tensor_parallel.unsharded(self.model):  # folded whole, then this rank's rows
            state = self.model.state_dict()
            folded = fold_batchnorm(state)
            changed = tensor_parallel.slice_state(self.model, {k: v for k, v in folded.items() if v is not state[k]})
        return _FoldedModel(self.model, changed)

    def _eval_generator(self, generator, phase, *, steps=None, callback_list=None):
        """One validation or test pass with BatchNorm on its running
        statistics, the live curation flags, and the MMTM running averages
        updated in the buffers."""
        if generator is None:
            return {}
        if self.controller_kind in ("weakest", "adaptive_weakest"):
            # Guided and random thread the live flags into the eval forwards,
            # as the reference does.  The weakest controllers' passes run
            # with curation off (a window could otherwise end an epoch
            # mid-curation and skew the per-modality accuracies their next
            # designation reads); the next train step recomputes the flag
            # (``framework.py:370-386``).
            self.ctrl = dataclasses.replace(self.ctrl, curation_mode=torch.zeros_like(self.ctrl.curation_mode))
        if steps is None:
            steps = len(generator)
        progress = ValidationProgressionCallback(phase=phase, steps=steps, metrics_names=["loss"] + self.metrics_names)
        progress.set_model_pytoune(self)
        records, recorded, sizes, indices = [], [], [], []
        accumulator = self.rescale_accumulator
        model = self._eval_model()
        for batch_ind, batch in _steps(generator, steps):
            batch_begin_time = timeit.default_timer()
            progress.on_batch_begin(batch_ind, {})
            size = batch["size"]
            with parallel.data_parallel(self.world):
                out = eval_step(model, self.ctrl, self._to_device(batch), mmtm_off=self.mmtm_off,
                                average_squeezemaps=self.average_squeezemaps)
            if self.world is None:
                indices.append(np.asarray(batch["indices"])[:size])
                real = size
            else:  # the rank's rows; its real ones come first
                indices.append(self._block_indices(batch))
                real = int((indices[-1] != -1).sum())
            if accumulator is not None and "squeezedmaps_array_list" in out:
                accumulator.consume(out.pop("squeezedmaps_array_list"),
                                    accumulator.member_mask(indices[-1], real, len(batch["mask"])))
            recorded.append({k: out.pop(k) for k in RECORD_KEYS if k in out})
            records.append(out)
            sizes.append(size)
            batch_logs = {"batch": batch_ind, "size": size, "batch_begin_time": batch_begin_time,
                          "loss": out["loss"], "acc": out["acc"]}
            progress.on_batch_end(batch_ind, batch_logs)
            if callback_list is not None and phase == "val":
                callback_list.on_val_batch_end(batch_ind, batch_logs)

        outs = _fetch(records)
        indices, sizes, recorded = self._pass_records(indices, sizes, recorded)
        sizes = np.array(sizes, np.float64)
        total = max(sizes.sum(), 1.0)
        losses = np.array([o["loss"] for o in outs], np.float64)
        info = {
            f"{phase}_loss": float((losses * sizes).sum() / total),
            f"{phase}_indices": np.concatenate(indices) if indices else [],
            f"{phase}_acc": float((np.array([o["acc"] for o in outs]) * sizes).sum() / total),
        }
        for i in range(self.nummodalities):
            vals = np.array([o["acc_modal"][i] for o in outs])
            info[f"{phase}_acc_modal_{i}"] = float((vals * sizes).sum() / total)
        for key, per_batch in recorded.items():
            info[f"{phase}_{key}"] = per_batch
        return info

    def train_loop(
        self,
        train_generator,
        test_generator=None,
        valid_generator=None,
        *,
        epochs=1000,
        steps_per_epoch=None,
        validation_steps=None,
        test_steps=None,
        callbacks=(),
        initial_epoch=1,
    ):
        """``framework.py:570-620``: for each epoch, train, then the
        validation and test passes, then ``on_epoch_end`` with the merged
        logs; stops after an epoch that set ``stop_training``."""
        callback_list = CallbackList(list(callbacks))
        if self.verbose:
            callback_list.append(ProgressionCallback())
        callback_list.set_model_pytoune(self)
        callback_list.set_params({"epochs": epochs, "steps": steps_per_epoch})

        self.stop_training = False
        self.distribute()  # every rank starts from rank 0's state
        callback_list.on_train_begin({})
        for epoch in range(initial_epoch, epochs + 1):
            callback_list.on_epoch_begin(epoch, {})
            epoch_begin_time = timeit.default_timer()
            if hasattr(train_generator, "set_epoch"):
                train_generator.set_epoch(epoch - 1)
            train_dict = self._train_epoch(train_generator, steps_per_epoch, callback_list)
            train_time = timeit.default_timer() - epoch_begin_time
            val_dict = self._eval_generator(valid_generator, "val", steps=validation_steps,
                                            callback_list=callback_list)
            test_dict = self._eval_generator(test_generator, "test", steps=test_steps)
            epoch_log = {
                "epoch": epoch,
                "time": timeit.default_timer() - epoch_begin_time,
                "epoch_begin_time": epoch_begin_time,
                "train_samples_per_sec": float(train_dict.pop("_num_samples", 0)) / max(train_time, 1e-9),
                **train_dict,
                **val_dict,
                **test_dict,
            }
            callback_list.on_epoch_end(epoch, epoch_log)
            if self.stop_training:
                break
        callback_list.on_train_end({})

    def eval_loop(self, test_generator, *, test_steps=None, epochs=1, callbacks=()):
        """Test passes numbered 0..``epochs``, so ``epochs=0`` runs one
        (``framework.py:679-694``), each ending in ``on_epoch_end``."""
        callback_list = CallbackList(list(callbacks))
        callback_list.set_model_pytoune(self)
        self._take_shards()
        callback_list.on_train_begin({})
        for epoch in range(epochs + 1):
            epoch_begin_time = timeit.default_timer()
            callback_list.on_epoch_begin(epoch, {})
            test_dict = self._eval_generator(test_generator, "test", steps=test_steps)
            test_dict["epoch"] = epoch
            test_dict["time"] = timeit.default_timer() - epoch_begin_time
            test_dict["epoch_begin_time"] = epoch_begin_time
            callback_list.on_epoch_end(epoch, test_dict)

    # --- serving ---

    @torch.no_grad()
    def predict(self, generator, steps=None):
        """Inference: iterate a batch pipeline and return per-sample
        predictions.

        Returns dict with ``indices`` (dataset order of the inputs),
        ``predictions`` (argmax of blended logits), ``probabilities``
        (softmax of blended logits) and per-view ``logits``, all numpy."""
        self.model.eval()
        if steps is None:
            steps = len(generator)
        all_idx, all_logits = [], []
        for batch in itertools.islice(_cycle(generator), steps):
            size = batch.pop("size")
            indices = batch.pop("indices")
            # The new MMTM state is discarded, as in the JAX package: predict
            # leaves the model's buffers as they were.
            _, logits = self._predict_step(batch)
            all_idx.append(np.asarray(indices)[:size])
            all_logits.append([l[:size] for l in logits])
        logits = [torch.cat([b[v] for b in all_logits]).cpu().numpy() for v in range(self.nummodalities)]
        blend = sum(logits) / float(self.nummodalities)
        ex = np.exp(blend - blend.max(axis=1, keepdims=True))
        return {
            "indices": np.concatenate(all_idx),
            "predictions": blend.argmax(axis=1),
            "probabilities": ex / ex.sum(axis=1, keepdims=True),
            "logits": logits,
        }

    @torch.no_grad()
    def _predict_step(self, batch):
        """One batch through the eval forward, the cross-modal flow cut when
        the trainer has ``mmtm_off``, as its eval passes run.  Returns (new
        MMTM state as ``{"mmtm2": {buffer: tensor}, ...}``, [per-view
        logits])."""
        images = _on_device(batch["images"], self.device)
        mask = _on_device(batch["mask"], self.device)
        x = preprocess(images, train=False, dtype=self.model.dtype)
        mmtm_state = {}
        _, logits, _, _ = self.model(x, valid_mask=mask, mmtm_state=mmtm_state, mmtm_off=self.mmtm_off,
                                     average_squeezemaps=self.average_squeezemaps)
        return mmtm_state, logits
