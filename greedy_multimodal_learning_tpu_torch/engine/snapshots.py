"""Asynchronous rotating full-state snapshots over
``torch.distributed.checkpoint`` (DCP): the port's counterpart of the JAX
package's ``OrbaxCheckpointer`` (``engine/checkpoint.py:159-235``) behind
``training_loop.orbax_dir`` / ``orbax_max_to_keep``.  The capability is
ported, not Orbax's file format.

:func:`state_to_tree` is the JAX package's ``state_to_tree``: the
parameters with the BatchNorm statistics and the MMTM buffers (the model's
state_dict), SGD's momentum buffers, the controller state with its PRNG
key, the step, the data key and the learning rate, as a flat dict of
tensors.  :class:`Snapshots` writes one into ``<directory>/<epoch>/`` with
``dcp.async_save``: the call copies the tensors to the host and returns,
and a background thread writes the files.

* **Completeness.**  DCP writes a snapshot's ``.metadata`` last, after
  every rank's files; a directory without one (an interrupted save) is
  never :meth:`Snapshots.latest_step`.
* **Rotation.**  Once a save has completed on every rank (:meth:`wait`,
  then a barrier), rank 0 deletes the complete snapshots beyond
  ``max_to_keep`` and the incomplete ones older than the newest.  A save
  waits for the one before it.
* **Ranks.**  Under data and tensor parallelism every rank takes part and
  writes its own part.  DCP keeps one copy of the tensors several ranks save
  under one key, which is right for the replicated ones; a weight split
  over a model group (and its momentum) goes under a key that names its row
  block (``<name>@rows<start>:<stop>/<rows>``), so no rank's rows are lost.
  A restore reads every block and joins them, so a snapshot taken at one
  ``model_parallel`` restores at any other.  DCP's background coordination
  needs a process group with a CPU backend: on cards a gloo group is made
  beside the NCCL one for it; the step's backend does not change.
* **Not Orbax's format.**  A directory that holds the JAX package's Orbax
  snapshots raises, naming the ``.jax.pkl`` sidecar the port does read.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import timeit
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..parallel import tensor as tensor_parallel
from ..parallel.multihost import is_main_process
from .controller import key_tensor
from .train_state import get_learning_rate, set_learning_rate

logger = logging.getLogger(__name__)

_ROWS = re.compile(r"^(?P<name>.+)@rows(?P<start>\d+):(?P<stop>\d+)/(?P<rows>\d+)$")
_METADATA = ".metadata"


def _block_key(key: str, shard) -> str:
    if shard is None:
        return key
    start = shard.index * shard.block
    return f"{key}@rows{start}:{start + shard.block}/{shard.rows}"


def state_to_tree(trainer) -> dict:
    """The trainer's whole training state as a flat {key: tensor} dict
    (``checkpoint.py:159-180``): ``model/<name>`` (the state_dict),
    ``momentum/<parameter>`` (SGD's buffers), ``controller/<field>``,
    ``step``, ``rng`` (the data key) and ``lr``.  A weight this rank holds
    rows of, and its momentum, are its rows, keyed by their block."""
    model, optimizer = trainer.model, trainer.optimizer
    shards = {f"{name}.weight": m.shard for name, m in model.named_modules() if getattr(m, "shard", None) is not None}
    tree = {_block_key(f"model/{k}", shards.get(k)): v.detach() for k, v in model.state_dict().items()}
    if optimizer is not None:
        for name, p in model.named_parameters():
            buf = optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                tree[_block_key(f"momentum/{name}", shards.get(name))] = buf.detach()
        tree["lr"] = torch.tensor(get_learning_rate(optimizer), dtype=torch.float64)
    for k, v in trainer.ctrl.as_dict().items():
        tree[f"controller/{k}"] = v.detach()
    tree["step"] = torch.tensor(trainer.step, dtype=torch.int64)
    tree["rng"] = key_tensor(trainer.data_key)
    return tree


def _join_blocks(tree: dict) -> dict:
    """``tree`` with each weight's row blocks joined into the whole tensor."""
    whole, blocks = {}, {}
    for key, value in tree.items():
        m = _ROWS.match(key)
        if m is None:
            whole[key] = value
        else:
            blocks.setdefault(m["name"], []).append((int(m["start"]), int(m["stop"]), int(m["rows"]), value))
    for name, parts in blocks.items():
        parts.sort(key=lambda part: part[0])
        covered = [(start, stop) for start, stop, _, _ in parts]
        rows = parts[0][2]
        if covered[0][0] != 0 or covered[-1][1] != rows or any(a[1] != b[0] for a, b in zip(covered, covered[1:])):
            raise ValueError(f"the snapshot's row blocks of {name} do not cover its {rows} rows: {covered}")
        whole[name] = torch.cat([value for _, _, _, value in parts])
    return whole


@torch.no_grad()
def tree_into_trainer(trainer, tree: dict) -> None:
    """:func:`state_to_tree`'s inverse (``checkpoint.py:183-202``): whole
    tensors into the trainer, each rank then keeping its rows of a split
    weight and its momentum; the controller, the step and the data key
    through :meth:`~.framework.Trainer.set_run_state`."""
    tree = _join_blocks(tree)
    model, optimizer = trainer.model, trainer.optimizer
    prefix = {kind: {k[len(kind) + 1:]: v for k, v in tree.items() if k.startswith(kind + "/")}
              for kind in ("model", "momentum", "controller")}
    with tensor_parallel.unsharded(model, optimizer):
        missing, unexpected = model.load_state_dict(prefix["model"], strict=False)
        if unexpected or [k for k in missing if not k.endswith("num_batches_tracked")]:
            raise KeyError(f"the snapshot does not match the model: missing {missing[:5]}, unexpected {unexpected[:5]}")
        if optimizer is not None:
            for name, p in model.named_parameters():
                if name in prefix["momentum"]:
                    buf = torch.empty_like(p)  # the parameter's memory format, as SGD makes its buffers
                    buf.copy_(prefix["momentum"][name])
                    optimizer.state[p]["momentum_buffer"] = buf
            if "lr" in tree:
                set_learning_rate(optimizer, float(tree["lr"]))
    trainer.set_run_state(prefix["controller"], int(tree["step"]), tree["rng"], "the snapshot")


def _orbax_written(path: str) -> bool:
    return os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA")) or os.path.isdir(os.path.join(path, "default"))


class Snapshots:
    """``OrbaxCheckpointer``'s API (``checkpoint.py:205-235``) over DCP:
    :meth:`save` (asynchronous), :meth:`latest_step`,
    :meth:`restore_latest` and :meth:`wait`; :meth:`close` waits and
    releases the process group it made.  ``world`` is the trainer's
    :class:`~..parallel.World` (None for one process)."""

    def __init__(self, directory, max_to_keep: int = 2, world=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(int(max_to_keep), 1)
        self.world = world
        self._pending = None  # (epoch, future) of the save in flight
        self._group, self._made_group = None, False
        if world is not None and dist.get_backend() != "gloo":
            # async_save coordinates over a CPU backend; the steps keep theirs
            self._group, self._made_group = dist.new_group(backend="gloo"), True
        if is_main_process():
            os.makedirs(self.directory, exist_ok=True)
        self._barrier()
        self.blocked_s = []  # how long each save held the caller: the copy to the host

    def _barrier(self):
        if self.world is not None:
            dist.barrier(group=self._group)

    def _steps(self):
        """(complete epochs, incomplete epochs), each ascending; a directory
        the JAX package's Orbax wrote raises."""
        complete, incomplete = [], []
        if not os.path.isdir(self.directory):
            return complete, incomplete
        for entry in os.listdir(self.directory):
            path = os.path.join(self.directory, entry)
            if not (entry.isdigit() and os.path.isdir(path)):
                continue
            if _orbax_written(path):
                raise ValueError(
                    f"{self.directory} holds the JAX package's Orbax snapshots ({path}), a format the port does not "
                    "read; resume the run from its model_last_epoch.pt and the .jax.pkl sidecar beside it "
                    "(training_loop.resume) and give the port's snapshots a directory of their own"
                )
            (complete if os.path.exists(os.path.join(path, _METADATA)) else incomplete).append(int(entry))
        return sorted(complete), sorted(incomplete)

    def clear(self) -> None:
        """Rank 0 removes every snapshot in the directory (a fresh run's
        stale ones, which would otherwise outrank its own), then every rank
        waits."""
        if is_main_process():
            complete, incomplete = self._steps()
            for e in complete + incomplete:
                shutil.rmtree(os.path.join(self.directory, str(e)), ignore_errors=True)
            if complete or incomplete:
                logger.info("Removed the stale snapshots %s of %s", complete + incomplete, self.directory)
        self._barrier()

    def latest_step(self) -> Optional[int]:
        """The newest complete snapshot's epoch, None when there is none."""
        complete, _ = self._steps()
        return complete[-1] if complete else None

    def save(self, epoch: int, trainer) -> None:
        """Start writing the trainer's state as snapshot ``epoch``: waits
        for the save before it (and rotates), copies the state to the host,
        and returns while a background thread writes the files."""
        self.wait()
        path = os.path.join(self.directory, str(int(epoch)))
        if is_main_process() and os.path.exists(path):
            shutil.rmtree(path)  # an interrupted save of this epoch, or one a resume went back past
        self._barrier()
        begin = timeit.default_timer()
        kwargs = {"process_group": self._group} if self.world is not None else {"no_dist": True}
        response = dcp.async_save(state_to_tree(trainer), checkpoint_id=path, **kwargs)
        self.blocked_s.append(timeit.default_timer() - begin)
        self._pending = (int(epoch), getattr(response, "upload_completion", response))

    def wait(self) -> None:
        """Block until the save in flight has completed on every rank, then
        rotate: rank 0 deletes the complete snapshots beyond
        ``max_to_keep`` and the incomplete ones older than the newest."""
        if self._pending is None:
            return
        epoch, future = self._pending
        self._pending = None
        future.result()
        self._barrier()
        if is_main_process():
            complete, incomplete = self._steps()
            stale = complete[:-self.max_to_keep] + [e for e in incomplete if complete and e < complete[-1]]
            for e in stale:
                shutil.rmtree(os.path.join(self.directory, str(e)), ignore_errors=True)
            logger.info("Snapshot of epoch %d written to %s (kept %s)", epoch, self.directory,
                        complete[-self.max_to_keep:])
        self._barrier()

    def restore_latest(self, trainer) -> Optional[int]:
        """Restore the newest complete snapshot into ``trainer``
        (:func:`tree_into_trainer`, at the trainer's model size whatever the
        snapshot's); returns its epoch, None (the trainer untouched) when
        there is none.  Each rank reads the whole snapshot."""
        epoch = self.latest_step()
        if epoch is None:
            return None
        path = os.path.join(self.directory, str(epoch))
        metadata = dcp.FileSystemReader(path).read_metadata()
        tree = {}
        for key, meta in metadata.state_dict_metadata.items():
            if not hasattr(meta, "size"):
                raise ValueError(f"{path}: {key} is not a tensor; not a snapshot of the port")
            tree[key] = torch.empty(tuple(meta.size), dtype=meta.properties.dtype)
        dcp.load(tree, checkpoint_id=path, no_dist=True)
        tree_into_trainer(trainer, tree)
        return epoch

    def close(self) -> None:
        """:meth:`wait`, then release the gloo group made for the saves."""
        try:
            self.wait()
        finally:
            if self._made_group:
                dist.destroy_process_group(self._group)
                self._made_group = False
