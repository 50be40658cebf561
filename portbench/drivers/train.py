"""Training traffic: the program's ``Trainer.train_loop``, the loop its
``train`` entry runs, with the controller callback the mix names, over a
``DeviceCachePipeline`` of the configuration's train split made from the
seed, shuffled per epoch.

* Set-up: the weights from the seed loaded into the program's model, the
  corpus, the optimizer and the trainer, then ``warmup_steps`` steps
  through ``train_loop`` itself (epoch 1): every shape the window uses, and
  the steps the check follows.
* Window: ``train_loop`` again from epoch 2, whole epochs of
  ``train_steps_per_epoch`` steps (one pass over the split when null),
  until another epoch would end past ``--seconds``.
  ``train_samples_per_s`` is the real samples of those epochs over their
  time, each epoch timed from its begin to its end on the host clock; the
  end comes after the loop's epoch-end fetch, which waits for the device.
* Traced window: one such epoch timed on the host clock, then one under
  the profiler, with the benchmark's spans around the pipeline's ``next``
  and the trainer's ``train_flips`` and ``train_batch``.
* Check, in two parts:

  - the start: the reference follows the first ``checked_steps`` steps of
    set-up from the same weights, rows and flips, worked out again from
    the seed.  Compared: each step's loss, the first gradient as the
    optimizer got it (the parameters' change in step 1 over the learning
    rate), the parameters' change over the steps, the running statistics
    and averages, each step's curation decision (where the reference's
    imbalance lies within rounding of giving the program's decision, a
    tie: the reference goes on with the program's);
  - a window step: the last step of the window's first epoch, which holds
    the split's remainder and pads the rest of its batch under mask 0 where
    the batch does not divide the split.  The reference takes the
    program's state and controller state from just before that step (the
    steps between are not replayed) and the step's rows and flips, worked
    out again from the seed.  Compared, as ``window_*``: the step's loss,
    its gradient as the optimizer got it, the running statistics and
    averages it moved, its curation decision.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import inputs
from portbench.bench import RunRecord
from portbench.reference import train as reference_train
from portbench.spans import Spans, TimedIterable
from portbench.trace import run_traced

# what the checks keep of a step's logs
LOGGED = ("loss", "curation_mode", "caring_modality", "d_BDR")

# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone and are left out of the change
ZERO_GRADIENT = 1e-3


def _callback_class(name):
    from greedy_multimodal_learning_tpu_torch.engine import callbacks

    return getattr(callbacks, name)


def _base_callback():
    from greedy_multimodal_learning_tpu_torch.engine.callbacks import Callback

    return Callback


def _capture_class():
    class Capture(_base_callback()):
        """Keeps, on the host, the parameters after step 1, the whole state
        after step ``last`` and every step's logs up to it."""

        def __init__(self, model, last):
            self.model, self.last = model, last
            self.logs, self.params1, self.state = [], None, None

        def on_batch_end(self, batch, logs):
            if batch > self.last:
                return
            self.logs.append({k: logs[k].detach().clone() for k in LOGGED})
            if batch == 1:
                self.params1 = {n: p.detach().to("cpu", copy=True) for n, p in self.model.named_parameters()}
            if batch == self.last:
                self.state = {n: t.detach().to("cpu", copy=True) for n, t in self.model.state_dict().items()}

    return Capture


def _step_capture_class():
    class StepCapture(_base_callback()):
        """Keeps, on the device, what step ``at`` (1-based in its epoch) of
        the first epoch it sees starts from: the whole state and the
        controller's; and what the step gives: its loss, its decision and the
        state after.  Device copies only, so the step does not wait."""

        def __init__(self, trainer, at):
            self.trainer, self.at = trainer, at
            self.before = self.ctrl = self.log = self.after = None

        def on_forward_begin(self, batch, data):
            if batch != self.at or self.before is not None:
                return
            self.before = {n: t.detach().clone() for n, t in self.trainer.model.state_dict().items()}
            c = self.trainer.ctrl
            self.ctrl = {k: getattr(c, k).detach().clone()
                         for k in ("M_main", "M_bypass", "curation_mode", "caring_modality", "curation_step")}

        def on_batch_end(self, batch, logs):
            if batch != self.at or self.after is not None or self.before is None:
                return
            self.log = {k: logs[k].detach().clone() for k in LOGGED}
            self.after = {n: t.detach().clone() for n, t in self.trainer.model.state_dict().items()}

    return StepCapture


def _window_class():
    class Window(_base_callback()):
        """Times whole epochs; stops the loop once another epoch would end
        past ``seconds``."""

        def __init__(self, trainer, seconds):
            self.trainer, self.seconds = trainer, seconds
            self.epochs, self.began, self.t0, self.elapsed = [], None, None, 0.0
            self.losses = []

        def on_epoch_begin(self, epoch, logs):
            self.began = time.perf_counter()
            if self.t0 is None:
                self.t0 = self.began

        def on_epoch_end(self, epoch, logs):
            now = time.perf_counter()
            self.epochs.append(now - self.began)
            self.losses.append(logs.get("loss", float("nan")))
            self.elapsed = now - self.t0
            if self.elapsed + float(np.mean(self.epochs)) > self.seconds:
                self.trainer.stop_training = True

    return Window


class Session:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config, self.traffic, self.family = cell.config, cell.traffic, cell.family
        self.arch = self.family.arch(self.config)
        self.attempted = self.failed = 0

    @property
    def steps_per_epoch(self):
        n, b = self.config["train_samples"], self.traffic["batch"]
        return self.config.get("train_steps_per_epoch") or -(-n // b)

    @property
    def samples_per_epoch(self):
        return min(self.steps_per_epoch * self.traffic["batch"], self.config["train_samples"])

    def setup(self):
        from greedy_multimodal_learning_tpu_torch.data.pipeline import DeviceCachePipeline
        from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer

        cfg, tr = self.config, self.traffic
        self.model = self.family.program_model(cfg, self.device)
        self.model.load_state_dict(inputs.weights(self.arch, self.seed, self.device))
        n = cfg["train_samples"]
        self.images, self.labels = inputs.corpus(self.family.sample_shape(cfg), n, cfg["classes"], self.seed,
                                                 inputs.TRAIN_CORPUS, self.device)
        self.pipe = DeviceCachePipeline(inputs.ArrayDataset(self.images, self.labels), np.arange(n), tr["batch"],
                                        device=self.device, shuffle=True, seed=self.seed)
        self.optimizer = make_optimizer(self.model.parameters(), **tr["optimizer"])
        ctrl = dict(tr["controller"])
        self.callback = _callback_class(ctrl.pop("callback"))(
            branchnames=[f"net_view_{i}" for i in range(self.arch.towers)], MMTMnames=self.arch.names, **ctrl)
        self.trainer = Trainer(self.model, self.optimizer, controller_kind=self.callback.controller_kind,
                               controller_config=self.callback.controller_config(), nummodalities=self.arch.towers,
                               verbose=False, device=self.device, seed=self.seed)
        self.capture = _capture_class()(self.model, tr["checked_steps"])
        self.step_capture = _step_capture_class()(self.trainer, self.steps_per_epoch)
        self.trainer.train_loop(self.pipe, epochs=1, steps_per_epoch=tr["warmup_steps"],
                                callbacks=[self.callback, self.capture])

    def _epochs(self, pipe, callbacks, epochs):
        self.trainer.train_loop(pipe, initial_epoch=2, epochs=1 + epochs, steps_per_epoch=self.steps_per_epoch,
                                callbacks=[self.callback, *callbacks])

    def window(self, seconds):
        timer = _window_class()(self.trainer, seconds)
        self._epochs(self.pipe, [timer, self.step_capture], 10 ** 9)
        steps = self.steps_per_epoch
        self.attempted = steps * len(timer.epochs)
        self.failed = steps * sum(1 for loss in timer.losses if not math.isfinite(loss))
        return {"train_samples_per_s": self.samples_per_epoch * len(timer.epochs) / sum(timer.epochs)}

    def traced_window(self):
        t0 = time.perf_counter()
        self._epochs(self.pipe, [self.step_capture], 1)
        untraced = time.perf_counter() - t0
        spans = Spans()
        spans.wrap_method(self.trainer, "train_flips", "portbench.flips")
        spans.wrap_method(self.trainer, "train_batch", "portbench.train_batch")
        pipe = TimedIterable(self.pipe, spans, "portbench.data")
        _, tr = run_traced(lambda: self._epochs(pipe, [], 1))
        self.attempted = 2 * self.steps_per_epoch
        return RunRecord(self.cell, tr, spans=dict(spans.seconds), units=self.steps_per_epoch,
                         samples=self.samples_per_epoch, untraced_s=untraced)

    def _free_program(self):
        for name in ("trainer", "model", "optimizer", "pipe", "callback"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _batch(self, epoch, k):
        """Batch ``k`` (0-based) of ``epoch`` as the pipeline makes it: the
        rows of the epoch's order, worked out again from the seed, padded
        to the batch with zero samples of label 0 under mask 0."""
        b, n = self.traffic["batch"], self.config["train_samples"]
        if k * b >= n:
            raise ValueError(f"batch {k} of {b} lies past the split of {n}")
        rows = np.random.default_rng((self.seed, epoch)).permutation(np.arange(n))[k * b:(k + 1) * b]
        images = np.zeros((b,) + self.images.shape[1:], np.uint8)
        labels = np.zeros(b, self.labels.dtype)
        mask = np.zeros(b, np.float32)
        images[:len(rows)], labels[:len(rows)], mask[:len(rows)] = self.images[rows], self.labels[rows], 1.0
        return tuple(torch.from_numpy(a).to(self.device) for a in (images, labels, mask))

    def _reference(self, state, batches, **kw):
        tr = self.traffic
        return reference_train.train_steps(
            self.arch, state, batches, seed=self.seed, lr=tr["optimizer"]["lr"], epsilon=tr["controller"]["epsilon"],
            window=tr["controller"]["curation_windowsize"], flip_shape=self.family.flip_shape, **kw)

    def check(self):
        tr, cap, step = self.traffic, self.capture, self.step_capture
        self._free_program()
        lr = tr["optimizer"]["lr"]
        state0 = inputs.weights(self.arch, self.seed, self.device)
        ref = self._reference(state0, [self._batch(1, k) for k in range(tr["checked_steps"])],
                              follow=[_decision(c) for c in cap.logs[:tr["checked_steps"]]])
        numbers = compare(cap, ref, {n: t.cpu() for n, t in state0.items()}, lr)
        self.notes = imbalance_notes(cap.logs, ref)
        del ref, state0
        if step.after is None:  # the window never reached the step
            return dict(numbers, **{f"window_{k}": float("nan") for k in WINDOW_NUMBERS})
        k = self.steps_per_epoch - 1
        before = {n: t.contiguous() for n, t in step.before.items()}
        c = step.ctrl
        ctrl = reference_train.Controller(c["M_main"].double(), c["M_bypass"].double(), bool(c["curation_mode"]),
                                          int(c["caring_modality"]), int(c["curation_step"]))
        ref = self._reference(before, [self._batch(2, k)], ctrl=ctrl, first_step=tr["warmup_steps"] + k,
                              follow=[_decision(step.log)])
        numbers.update(compare_step(step, ref, lr))
        self.notes.update({f"window_{name}": v for name, v in imbalance_notes([step.log], ref).items()})
        return numbers


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def _worst_gap(mine, theirs, keep=None):
    """Worst leaf of |mine - theirs| over max(theirs, the median leaf's
    theirs), over the leaves ``keep`` holds (all when None)."""
    names = [n for n in theirs if keep is None or n in keep]
    if not names:
        return 0.0
    median = float(np.median([theirs[n] for n in names]))
    return max(abs(mine[n] - theirs[n]) / max(theirs[n], median, 1e-30) for n in names)


WINDOW_NUMBERS = ("loss_gap", "grad_gap", "buffer_gap", "decisions_differ")


def _buffers(state):
    return [n for n in state if n.endswith(("running_mean", "running_var")) or ".running_avg_" in n]


def imbalance_notes(logs, ref):
    """What the check prints of the controller beside its numbers: the
    widest gap of the imbalance (``d_BDR``) from the reference's, the
    nearest the reference's came to its threshold at a step that decided,
    and the ties the reference settled the program's way."""
    gaps = [abs(float(c["d_BDR"]) - r) for c, r in zip(logs, ref["d_BDR"]) if r is not None]
    return {"imbalance_gap": max(gaps, default=0.0), "decision_margin": min(ref["margins"], default=None),
            "ties": float(ref["ties"])}


def _decision(log):
    return bool(log["curation_mode"]), int(log["caring_modality"]) if bool(log["curation_mode"]) else 0


def compare_step(cap, ref, lr):
    """The numbers of one window step: ``cap`` the program's capture of it,
    ``ref`` the reference's step from the same state before it."""
    before = {n: t.cpu() for n, t in cap.before.items()}
    after = {n: t.cpu() for n, t in cap.after.items()}
    ref_state = {n: t.cpu() for n, t in ref["state"].items()}
    names = list(ref["grads"])
    g_ref = {n: _norm(ref["grads"][n]) for n in names}
    g_mine = {n: _norm((before[n] - after[n]) / lr) for n in names}
    buffers = _buffers(ref_state)
    b_ref = {n: _norm(ref_state[n] - before[n]) for n in buffers}
    b_mine = {n: _norm(after[n] - before[n]) for n in buffers}
    loss, ref_loss = float(cap.log["loss"]), ref["losses"][0]
    return {
        "window_loss_gap": abs(loss - ref_loss) / abs(ref_loss),
        "window_grad_gap": _worst_gap(g_mine, g_ref),
        "window_buffer_gap": _worst_gap(b_mine, b_ref),
        "window_decisions_differ": float(_decision(cap.log) != ref["decisions"][0]),
    }


def compare(cap, ref, state0, lr):
    """The numbers a train cell compares; ``cap`` the program's capture,
    ``ref`` the reference's steps, ``state0`` the initial state."""
    steps = len(ref["losses"])
    losses = [float(c["loss"]) for c in cap.logs[:steps]]
    decisions = [_decision(c) for c in cap.logs[:steps]]
    names = list(ref["grads"])
    g_ref = {n: _norm(ref["grads"][n]) for n in names}
    g_mine = {n: _norm((state0[n] - cap.params1[n]) / lr) for n in names}
    median_g = float(np.median(list(g_ref.values())))
    moving = {n for n in names if g_ref[n] >= ZERO_GRADIENT * median_g}
    ref_state = {n: t.cpu() for n, t in ref["state"].items()}
    d_ref = {n: _norm(ref_state[n] - state0[n]) for n in names}
    d_mine = {n: _norm(cap.state[n] - state0[n]) for n in names}
    buffers = _buffers(ref_state)
    b_ref = {n: _norm(ref_state[n] - state0[n]) for n in buffers}
    b_mine = {n: _norm(cap.state[n] - state0[n]) for n in buffers}
    return {
        "loss_gap": max(abs(a - r) / abs(r) for a, r in zip(losses, ref["losses"])),
        "grad_gap": _worst_gap(g_mine, g_ref),
        "change_gap": _worst_gap(d_mine, d_ref, moving),
        "buffer_gap": _worst_gap(b_mine, b_ref),
        "decisions_differ": float(sum(a != r for a, r in zip(decisions, ref["decisions"]))),
    }
