"""Weights across the two packages.

The JAX package writes ``{"model": state_dict, "optimizer": {}}`` with
``torch.save`` (``greedy_multimodal_learning_tpu/engine/checkpoint.py:90-101``),
the state_dict named as torchvision names a ResNet-18 (convs OIHW, linears
(out, in), ``layerN.k``, ``downsample.0/1``).  The port's modules carry
exactly those names, so such a file loads with ``load_state_dict``.

Beside it the JAX package writes the sidecar ``<file>.jax.pkl``: a pickle
of numpy trees (parameters, BatchNorm statistics, MMTM buffers, controller,
step, PRNG keys, learning rate) and of optax's optimizer state, whose
classes are optax NamedTuples.  :func:`read_jax_sidecar` reads it without
jax or optax: an unpickler that takes numpy's array reconstruction, stands
a tuple in for each optax class, and refuses every other global.
``state_dict_from_jax`` turns its trees into the port's state_dict, MMTM
buffers included.  ``load_weights`` takes the sidecar when there is one,
as the JAX package's ``load_pretrained`` does (``checkpoint.py:131-142``).

``save_weights`` writes the ``.pt`` the same way (no MMTM buffers, no
``num_batches_tracked``), so the JAX package reads the port's checkpoints,
plus a torch-native sidecar ``<file>.torch.pt`` with what the ``.pt`` lacks:
the MMTM buffers, the controller state with its PRNG key, the step, the
data key and the optimizer state.  ``load_training_state`` reads either
sidecar back for a resume (``checkpoint.py:238-305``): the port's own, or
the JAX package's, whose momentum trace becomes ``torch.optim.SGD``'s
momentum buffers and whose two keys continue the JAX run's draws.

A checkpoint has one sidecar, chosen in one place (:func:`_sidecar`): the
port removes a ``.jax.pkl`` when it rewrites a file, but the JAX package
leaves a ``.torch.pt`` where it writes, so both beside one ``.pt`` raise
rather than mix one package's weights with the other's optimizer state.
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
import os
import pickle
import re

import numpy as np
import torch

from .controller import ControllerState, init_controller_state, key_tensor

logger = logging.getLogger(__name__)

# The globals numpy's array pickles reference, under numpy 1's module names
# (``numpy.core.*``) and numpy 2's (``numpy._core.*``).
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy.core.numeric", "numpy._core.multiarray",
                  "numpy._core.numeric")
_NUMPY_NAMES = ("_frombuffer", "_reconstruct", "dtype", "ndarray")

# Field names of the optax states the port reads (``make_optimizer``'s
# chain, ``engine/train_state.py:39-52``); any other optax class keeps its
# values by position only.
_OPTAX_FIELDS = {
    "InjectStatefulHyperparamsState": ("count", "hyperparams", "hyperparams_states", "inner_state"),
    "TraceState": ("trace",),
}


class OptaxState(tuple):
    """Stand-in for an optax NamedTuple read from a pickle: a tuple of its
    values that keeps the class's name (``type(x).__name__``) and, for the
    classes of ``_OPTAX_FIELDS``, its field names as attributes."""

    fields = ()

    def __new__(cls, *values):
        return super().__new__(cls, values)

    def __getattr__(self, name):
        if name in type(self).fields:
            return self[type(self).fields.index(name)]
        raise AttributeError(f"{type(self).__name__} has no field {name!r}")

    def __repr__(self):
        return f"{type(self).__name__}{tuple(self)!r}"


_STAND_INS = {}


def _optax_stand_in(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STAND_INS:
        _STAND_INS[key] = type(name, (OptaxState,), {"fields": _OPTAX_FIELDS.get(name, ()), "__module__": module})
    return _STAND_INS[key]


def _numpy_global(module: str, name: str):
    if module == "numpy":
        return getattr(np, name)
    submodule = module.rsplit(".", 1)[1]
    for package in ("numpy._core", "numpy.core"):  # numpy 2, then numpy 1
        try:
            return getattr(importlib.import_module(f"{package}.{submodule}"), name)
        except (ImportError, AttributeError):
            continue
    raise pickle.UnpicklingError(f"numpy has no {module}.{name}")


class _SidecarUnpickler(pickle.Unpickler):
    """Numpy's reconstruction globals, optax classes as :class:`OptaxState`
    stand-ins, nothing else."""

    def find_class(self, module, name):
        if module == "optax" or module.startswith("optax."):
            return _optax_stand_in(module, name)
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            return _numpy_global(module, name)
        raise pickle.UnpicklingError(
            f"refusing the global {module}.{name}: a .jax.pkl sidecar references numpy and optax only"
        )


def read_jax_sidecar(path) -> dict:
    """The JAX package's ``<checkpoint>.jax.pkl`` (``checkpoint.py:103-128``)
    as a dict of numpy trees, its optax states as :class:`OptaxState`
    tuples.  Imports neither jax nor optax; any global but numpy's array
    reconstruction and optax's classes raises ``pickle.UnpicklingError``."""
    with open(path, "rb") as f:
        return _SidecarUnpickler(f).load()


def _find_states(tree, class_name):
    """Every :class:`OptaxState` named ``class_name`` inside ``tree``."""
    if isinstance(tree, OptaxState) and type(tree).__name__ == class_name:
        yield tree
    children = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (tuple, list)) else ()
    for item in children:
        yield from _find_states(item, class_name)


def _flatten(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _torchify_path(parts):
    tparts = []
    for p in parts:
        m = re.fullmatch(r"layer(\d)_(\d)", p)
        if m:
            tparts.extend([f"layer{m.group(1)}", m.group(2)])
        elif p == "downsample_conv":
            tparts.extend(["downsample", "0"])
        elif p == "downsample_bn":
            tparts.extend(["downsample", "1"])
        else:
            tparts.append(p)
    return tparts


def state_dict_from_jax(params, batch_stats, mmtm=None) -> dict:
    """The JAX package's (params, batch_stats[, mmtm]) trees -> the port's
    state_dict (``engine/checkpoint.py:42-82`` naming).  Flax kernels
    (*spatial, I, O) become OIHW convs, (in, out) kernels become (out, in)
    linear weights, BN ``scale`` becomes ``weight`` and ``mean``/``var``
    become ``running_mean``/``running_var``; ``mmtm`` entries become the
    ``mmtm<k>.running_avg_<name>`` / ``mmtm<k>.step`` buffers."""
    out = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        tparts, leafname = _torchify_path(path[:-1]), path[-1]
        if leafname == "kernel":
            if arr.ndim >= 3:
                axes = (arr.ndim - 1, arr.ndim - 2) + tuple(range(arr.ndim - 2))
                arr = np.transpose(arr, axes)
            else:
                arr = arr.T
            leafname = "weight"
        elif leafname == "scale":
            leafname = "weight"
        out[".".join(tparts + [leafname])] = arr
    for path, leaf in _flatten(batch_stats):
        name = "running_mean" if path[-1] == "mean" else "running_var"
        out[".".join(_torchify_path(path[:-1]) + [name])] = np.asarray(leaf)
    for path, leaf in _flatten(mmtm or {}):
        out[".".join(path)] = np.asarray(leaf)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in out.items()}


def _sidecar_state_dict(sidecar: dict) -> dict:
    return state_dict_from_jax(sidecar["params"], sidecar["batch_stats"], sidecar.get("mmtm"))


def _sidecar(filepath):
    """``("torch", path)`` for the port's ``<file>.torch.pt``, ``("jax",
    path)`` for the JAX package's ``<file>.jax.pkl``, ``(None, None)`` when
    there is neither.  Both raise: one of them is stale, and which one the
    files cannot say."""
    torch_side, jax_side = f"{filepath}.torch.pt", f"{filepath}.jax.pkl"
    have_torch, have_jax = os.path.exists(torch_side), os.path.exists(jax_side)
    if have_torch and have_jax:
        raise ValueError(
            f"{filepath} has two sidecars, {torch_side} (the port's) and {jax_side} (the JAX package's); "
            "remove the one that does not belong to the run that last wrote the checkpoint"
        )
    if have_torch:
        return "torch", torch_side
    if have_jax:
        return "jax", jax_side
    return None, None


def _load_state(model: torch.nn.Module, filepath, state) -> None:
    missing, unexpected = model.load_state_dict(state, strict=False)
    if state and len(unexpected) == len(state):
        logger.warning(
            "checkpoint %s matched 0 of %d entries: the model keeps its initialization", filepath, len(state)
        )
    not_loaded = [k for k in missing if not k.endswith("num_batches_tracked")]
    logger.info("Loaded %s (%d entries; not in the file: %d)", filepath, len(state) - len(unexpected), len(not_loaded))


def _load_pt(model: torch.nn.Module, filepath) -> None:
    ckpt = torch.load(filepath, map_location="cpu", weights_only=True)
    _load_state(model, filepath, ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt)


def load_weights(model: torch.nn.Module, filepath) -> None:
    """Non-strict load of a checkpoint into ``model``: keys the model lacks
    are ignored, parameters the file lacks keep their values, shape
    mismatches raise.  When the JAX package's ``<file>.jax.pkl`` is there,
    the parameters, BatchNorm statistics and MMTM buffers come from it
    (``checkpoint.py:131-142``); otherwise from the ``.pt``.  Both
    sidecars beside one file raise (:func:`_sidecar`)."""
    if not filepath:
        raise ValueError("checkpoint path is required (e.g. bind predict_.pretrained_weights_path='RUN/model_best_val.pt')")
    kind, sidecar_path = _sidecar(filepath)
    if kind == "jax":
        _load_state(model, sidecar_path, _sidecar_state_dict(read_jax_sidecar(sidecar_path)))
    else:
        _load_pt(model, filepath)


def _is_portable(key: str) -> bool:
    """Keys of the state_dict the JAX package writes and reads: parameters
    and BatchNorm statistics, no MMTM buffers, no ``num_batches_tracked``."""
    return not (key.endswith("num_batches_tracked") or ".running_avg_" in key or key.endswith(".step"))


def _atomic_save(obj, path):
    """torch.save to a temporary file, then rename: a crash mid-save never
    leaves a truncated checkpoint."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_weights(model: torch.nn.Module, filepath, *, optimizer=None, controller=None, step=None,
                 rng=None) -> None:
    """Write ``{"model": state_dict, "optimizer": {}}`` as the JAX package
    does (``checkpoint.py:85-101``), then the sidecar ``<file>.torch.pt``
    with the MMTM buffers, the controller state (a dict of tensors, its
    PRNG key under ``rng``), the global step, the data key ``rng`` (a (2,)
    int64 tensor of the key's words) and the optimizer's state_dict.  A JAX package's
    ``<file>.jax.pkl`` left there (a resumed run of the JAX package) no
    longer describes the file and is removed: both packages read it first."""
    state = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}
    if os.path.exists(f"{filepath}.jax.pkl"):
        logger.info("Removing %s.jax.pkl: %s is rewritten by the port", filepath, filepath)
        os.remove(f"{filepath}.jax.pkl")
    _atomic_save({"model": {k: v for k, v in state.items() if _is_portable(k)}, "optimizer": {}}, filepath)
    _atomic_save(
        {
            "mmtm": {k: v for k, v in state.items() if k.startswith("mmtm") and not _is_portable(k)},
            "controller": {k: v.detach().cpu() for k, v in (controller or {}).items()},
            "step": step,
            "rng": None if rng is None else key_tensor(rng),
            "optimizer": optimizer.state_dict() if optimizer is not None else None,
        },
        f"{filepath}.torch.pt",
    )


def load_training_state(model: torch.nn.Module, optimizer, filepath) -> dict:
    """Load ``filepath`` and its sidecar into ``model`` (parameters,
    BatchNorm statistics, MMTM buffers) and ``optimizer``; returns
    ``{"controller": {name: tensor}, "step": int, "rng": data key}``, the
    controller's ``rng`` and the data key as (2,) int64 tensors, or absent
    and None for a port sidecar written before the port carried them.  The
    sidecar is the port's ``<file>.torch.pt`` or the JAX package's
    ``<file>.jax.pkl`` (:func:`_load_jax_training_state`).  Raises
    FileNotFoundError when neither is there and ValueError when both are."""
    kind, sidecar_path = _sidecar(filepath)
    if kind == "jax":
        return _load_jax_training_state(model, optimizer, sidecar_path)
    if kind is None:
        raise FileNotFoundError(
            f"resume needs {filepath}.torch.pt (the port's sidecar) or {filepath}.jax.pkl (the JAX package's) "
            f"beside {filepath}"
        )
    _load_pt(model, filepath)
    side = torch.load(sidecar_path, map_location="cpu", weights_only=True)
    missing = [k for k in side["mmtm"] if k not in model.state_dict()]
    if missing:
        raise KeyError(f"{sidecar_path}: MMTM buffers the model lacks: {missing}")
    model.load_state_dict(side["mmtm"], strict=False)
    if optimizer is not None and side["optimizer"] is not None:
        optimizer.load_state_dict(side["optimizer"])
    logger.info("Restored %s and its sidecar (step %s)", filepath, side["step"])
    return {"controller": side["controller"], "step": int(side["step"]), "rng": side.get("rng")}


def _load_jax_training_state(model: torch.nn.Module, optimizer, sidecar_path) -> dict:
    """A resume from the JAX package's sidecar, as its ``load_into_state(...,
    full_restore=True)`` restores one (``checkpoint.py:238-305``):
    parameters, BatchNorm statistics, MMTM buffers, the controller state
    with its PRNG key, the step, the data key, the learning rate into every
    param group and optax's momentum trace into SGD's ``momentum_buffer``.
    An entry the model lacks, or a momentum setting that disagrees with the
    run's optimizer state, raises."""
    side = read_jax_sidecar(sidecar_path)
    _, unexpected = model.load_state_dict(_sidecar_state_dict(side), strict=False)
    if unexpected:
        raise KeyError(f"{sidecar_path}: entries the model lacks: {unexpected[:5]} ({len(unexpected)} in all)")
    ctrl = side["controller"]
    like = init_controller_state(len(np.asarray(ctrl["M_main"]))).as_dict()
    controller = {f.name: torch.from_numpy(np.array(ctrl[f.name], copy=True)).to(like[f.name].dtype)
                  for f in dataclasses.fields(ControllerState) if f.name in ctrl}
    if optimizer is not None:
        _restore_optimizer(model, optimizer, side, sidecar_path)
    step = int(np.asarray(side["step"]))
    logger.info("Restored %s (step %d)", sidecar_path, step)
    data_key = side.get("rng")
    return {"controller": controller, "step": step, "rng": None if data_key is None else key_tensor(np.asarray(data_key))}


def _restore_optimizer(model, optimizer, side, sidecar_path):
    """The learning rate and the momentum trace of the sidecar's optax state
    into ``optimizer`` (``torch.optim.SGD``).  optax's trace starts at zero
    and torch's buffer at the first gradient, so the two agree only while
    the buffer exists: every parameter gets one, a zero trace included."""
    opt_state = side.get("opt_state")
    hyper = getattr(opt_state, "hyperparams", None) or side.get("opt_hyperparams") or {}
    if "learning_rate" in hyper:
        lr = float(np.asarray(hyper["learning_rate"]))
        for group in optimizer.param_groups:
            group["lr"] = lr
    traces = list(_find_states(opt_state, "TraceState"))
    momentum = any(group.get("momentum", 0) for group in optimizer.param_groups)
    if len(traces) > 1 or bool(traces) != momentum:
        raise ValueError(
            f"{sidecar_path}: its optimizer state holds {len(traces)} momentum trace(s), the optimizer has "
            f"momentum {[group.get('momentum', 0) for group in optimizer.param_groups]}; bind train.momentum "
            "as the run was trained"
        )
    if not traces:
        return
    buffers = state_dict_from_jax(traces[0].trace, {})
    names = {p: n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names.get(p)
            if name not in buffers:
                raise KeyError(f"{sidecar_path}: no momentum trace for parameter {name}")
            buf = torch.empty_like(p)  # the parameter's memory format, as SGD makes its buffers
            buf.copy_(buffers[name])
            optimizer.state[p]["momentum_buffer"] = buf
