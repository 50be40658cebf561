"""Weights across the two packages.

The JAX package writes ``{"model": state_dict, "optimizer": {}}`` with
``torch.save`` (``greedy_multimodal_learning_tpu/engine/checkpoint.py:90-101``),
the state_dict named as torchvision names a ResNet-18 (convs OIHW, linears
(out, in), ``layerN.k``, ``downsample.0/1``).  The port's modules carry
exactly those names, so such a file loads with ``load_state_dict``.

The JAX package's ``.jax.pkl`` sidecar pickles optax state, and unpickling it
would import jax, so the port reads the ``.pt`` only: MMTM running averages
then start at zero.  ``state_dict_from_jax`` builds the same state_dict
straight from the JAX package's parameter trees (nested dicts of arrays),
MMTM buffers included.

``save_weights`` writes the ``.pt`` the same way (no MMTM buffers, no
``num_batches_tracked``), so the JAX package reads the port's checkpoints,
plus a torch-native sidecar ``<file>.torch.pt`` with what the ``.pt`` lacks:
the MMTM buffers, the controller state, the step and the optimizer state.
``load_training_state`` reads both back for an exact resume
(``checkpoint.py:238-305``); a run of the JAX package cannot be resumed
here, since its ``.jax.pkl`` pickles optax.
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np
import torch

logger = logging.getLogger(__name__)


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


def load_weights(model: torch.nn.Module, filepath) -> None:
    """Non-strict load of a JAX-written ``.pt`` checkpoint into ``model``:
    keys the model lacks are ignored, parameters the file lacks keep their
    values, shape mismatches raise."""
    if not filepath:
        raise ValueError("checkpoint path is required (e.g. bind predict_.pretrained_weights_path='RUN/model_best_val.pt')")
    ckpt = torch.load(filepath, map_location="cpu", weights_only=True)
    state = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    missing, unexpected = model.load_state_dict(state, strict=False)
    if state and len(unexpected) == len(state):
        logger.warning(
            "checkpoint %s matched 0 of %d entries: the model keeps its initialization", filepath, len(state)
        )
    not_loaded = [k for k in missing if not k.endswith("num_batches_tracked")]
    logger.info("Loaded %s (%d entries; not in the file: %d)", filepath, len(state) - len(unexpected), len(not_loaded))


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


def save_weights(model: torch.nn.Module, filepath, *, optimizer=None, controller=None, step=None) -> None:
    """Write ``{"model": state_dict, "optimizer": {}}`` as the JAX package
    does (``checkpoint.py:85-101``), then the sidecar ``<file>.torch.pt``
    with the MMTM buffers, the controller state (a dict of tensors), the
    global step and the optimizer's state_dict."""
    state = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}
    _atomic_save({"model": {k: v for k, v in state.items() if _is_portable(k)}, "optimizer": {}}, filepath)
    _atomic_save(
        {
            "mmtm": {k: v for k, v in state.items() if k.startswith("mmtm") and not _is_portable(k)},
            "controller": {k: v.detach().cpu() for k, v in (controller or {}).items()},
            "step": step,
            "optimizer": optimizer.state_dict() if optimizer is not None else None,
        },
        f"{filepath}.torch.pt",
    )


def load_training_state(model: torch.nn.Module, optimizer, filepath) -> dict:
    """Load ``filepath`` and its sidecar ``<file>.torch.pt`` into ``model``
    (parameters, BatchNorm statistics, MMTM buffers) and ``optimizer``;
    returns the sidecar's ``{"controller": {name: tensor}, "step": int}``.
    Raises FileNotFoundError when the sidecar is missing."""
    sidecar_path = f"{filepath}.torch.pt"
    if not os.path.exists(sidecar_path):
        other = " (a .jax.pkl sidecar is there: the JAX package's runs resume only in the JAX package)" if (
            os.path.exists(f"{filepath}.jax.pkl")) else ""
        raise FileNotFoundError(
            f"resume needs {sidecar_path}, the sidecar save_weights writes beside {filepath}{other}"
        )
    load_weights(model, filepath)
    side = torch.load(sidecar_path, map_location="cpu", weights_only=True)
    missing = [k for k in side["mmtm"] if k not in model.state_dict()]
    if missing:
        raise KeyError(f"{sidecar_path}: MMTM buffers the model lacks: {missing}")
    model.load_state_dict(side["mmtm"], strict=False)
    if optimizer is not None and side["optimizer"] is not None:
        optimizer.load_state_dict(side["optimizer"])
    logger.info("Restored %s and its sidecar (step %s)", filepath, side["step"])
    return {"controller": side["controller"], "step": int(side["step"])}
