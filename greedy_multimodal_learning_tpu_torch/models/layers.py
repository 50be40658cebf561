"""Building-block layers with the JAX package's numerics
(``greedy_multimodal_learning_tpu/models/layers.py``), for the 2-D family's
(B, C, H, W) maps and the 3-D family's (B, C, T, H, W) maps alike.

Parameters and BatchNorm statistics stay float32 whatever the compute
dtype; convolution and linear weights are cast to the activation's dtype at
use, as flax's ``dtype=`` does.  BatchNorm computes in float32 and casts
back to the compute dtype (``layers.py:83-120``); in train mode its batch
statistics cover the unmasked rows only, over every axis but the channel.

:func:`rematerialize` runs a block under ``torch.utils.checkpoint`` (flax's
``nn.remat``): its activations are recomputed in the backward pass instead
of kept, and the recompute leaves the BatchNorm running statistics alone,
so they take one update a forward, as with flax.

Under data parallelism (:func:`~..parallel.data_parallel`) the train-mode
statistics are the world's: the sums and the valid count, then the centred
sums of squares, each summed over the data group through a differentiable
all-reduce, so the backward sums the ranks' upstream gradients as
``SyncBatchNorm``'s does and every rank's running statistics take the global
mean, variance and count.  Under tensor parallelism a convolution or linear
whose weight :func:`~..parallel.tensor.shard_module_` split runs
column-parallel over the model group (:mod:`..parallel.tensor`).
"""

from __future__ import annotations

import contextlib
import functools
import math
import re
import threading

import numpy as np
import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from ..ops.masked_batch_norm import MaskedBatchNormFunction
from ..parallel import mesh as parallel
from ..parallel import tensor as tensor_parallel
from ..utils import prng


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (no bias) whose float32 weight is cast to the input's
    dtype at use; column-parallel once its weight is sharded (``shard``)."""

    shard = None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.shard is None:
            return self._conv_forward(x, w, None)
        return tensor_parallel.column_parallel(lambda t: self._conv_forward(t, w, None), x, self.shard, 1)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` (no bias) whose float32 weight is cast to the input's
    dtype at use; column-parallel once its weight is sharded (``shard``)."""

    shard = None
    forward = Conv2d.forward


def conv3x3(cin, cout, stride=1):
    return Conv2d(cin, cout, 3, stride, 1, bias=False)


def conv1x1(cin, cout, stride=1):
    return Conv2d(cin, cout, 1, stride, 0, bias=False)


class Linear(nn.Linear):
    """``TorchLinear`` (``layers.py:50-62``): the input, weight and bias are
    cast to the compute dtype and the bias is added in that dtype;
    column-parallel once its weight is sharded (``shard``), the whole bias
    added after the join."""

    shard = None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.shard is None:
            y = F.linear(x, w)
        else:
            y = tensor_parallel.column_parallel(lambda t: F.linear(t, w), x, self.shard, -1)
        return y + self.bias.to(x.dtype)


# Set on the thread that recomputes a checkpointed block (the autograd
# engine's, during the backward pass).
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    previous = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = previous


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


def rematerialize(block, *args):
    """``block(*args)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); the recompute skips the
    masked BatchNorm's running-statistics update."""
    return torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False, context_fn=_remat_contexts)


def _kernel_route(x) -> bool:
    """Whether the train-mode BatchNorm of ``x`` runs
    :class:`~..ops.masked_batch_norm.MaskedBatchNormFunction` (CUDA tensors:
    the kernels) rather than the plain ops (CPU tensors)."""
    return x.is_cuda


class _MaskedBatchNorm:
    """``TorchBatchNorm``'s semantics (``layers.py:83-120``) for a torch
    BatchNorm (eps 1e-5, momentum 0.1) on (B, C, *spatial) maps; the
    explicit ``train`` argument, not ``self.training``, selects the
    statistics, as in the JAX package.  ``relu`` applies the ReLU that
    follows the BatchNorm in the same call (the CUDA kernels take it into
    their passes).

    * ``train=False``: the running statistics, in one ``F.batch_norm`` pass
      (float32 statistics and affine, float32 normalize, the result in the
      input's dtype, as ``layers.py:118-120``).
    * ``train=True``: batch statistics over the rows whose (B,) ``mask`` is
      non-zero (all rows without a mask) and every spatial position, in
      float32; the normalize uses the biased variance, the running variance
      takes the unbiased one ``var * n / max(n - 1, 1)``.  ``F.batch_norm``
      cannot mask: on CUDA tensors the hand-written kernels of
      :mod:`..ops.masked_batch_norm` run it (two levels of sums, normalize,
      and a backward derived from this graph), on CPU tensors the plain torch
      ops below.  A :func:`rematerialize` recompute does not update the
      running statistics a second time.  Under data parallelism both passes'
      sums, and the count, are the data group's."""

    def forward(self, x, train: bool = False, mask=None, relu: bool = False):
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
            # in place: x, y and a third map would be alive at once (F.batch_norm's backward reads x, not y)
            return torch.relu_(y) if relu else y
        world = parallel.active()
        if _kernel_route(x):
            return MaskedBatchNormFunction.apply(
                x, self.weight, self.bias, self.running_mean, self.running_var, mask, self.momentum, self.eps,
                not getattr(_RECOMPUTE, "active", False), relu, world)
        xf = x.float()
        dims = (0,) + tuple(range(2, x.dim()))
        per_channel = (1, -1) + (1,) * (x.dim() - 2)
        m = torch.ones(x.shape[0], device=x.device) if mask is None else mask.float()
        m = m.view((-1,) + (1,) * (x.dim() - 1))
        n = m.sum() * math.prod(x.shape[2:])
        total = (xf * m).sum(dim=dims)
        if world is not None:
            total, n = parallel.differentiable_sum(torch.cat([total, n[None]]), world.data_group).split(
                [total.numel(), 1])
            n = n[0].detach()  # a count: no gradient
        mean = total / n
        centered = xf - mean.view(per_channel)
        squares = (centered.square() * m).sum(dim=dims)
        if world is not None:
            squares = parallel.differentiable_sum(squares, world.data_group)
        var = squares / n
        if not getattr(_RECOMPUTE, "active", False):
            self._update_running(mean, var, n)
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (centered * inv.view(per_channel) + self.bias.view(per_channel)).to(x.dtype)
        return torch.relu(y) if relu else y

    @torch.no_grad()
    def _update_running(self, mean, var, n):
        unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
        self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
        self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)


class BatchNorm2d(_MaskedBatchNorm, nn.BatchNorm2d):
    """The masked BatchNorm on (B, C, H, W) maps."""


class BatchNorm3d(_MaskedBatchNorm, nn.BatchNorm3d):
    """The masked BatchNorm on (B, C, T, H, W) maps."""


def jax_param_path(name: str, norm: bool = False) -> tuple:
    """The JAX package's parameter path for the port's parameter ``name``
    (the inverse of ``engine/checkpoint.py::state_dict_from_jax``'s names):
    ``layerN.k`` is ``layerN_k``, ``downsample.0`` / ``.1`` are
    ``downsample_conv`` / ``downsample_bn``; the leaf ``weight`` is flax's
    ``scale`` for a BatchNorm (``norm``) and its ``kernel`` otherwise."""
    parts = name.split(".")
    out, i = [], 0
    while i < len(parts) - 1:
        p, nxt = parts[i], parts[i + 1]
        if re.fullmatch(r"layer\d", p) and nxt.isdigit():
            out.append(f"{p}_{nxt}")
            i += 2
        elif p == "downsample" and nxt in ("0", "1"):
            out.append("downsample_conv" if nxt == "0" else "downsample_bn")
            i += 2
        else:
            out.append(p)
            i += 1
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "scale" if norm else "kernel"
    return tuple(out) + (leaf,)


# flax's make_rng counter of a parameter within its module's scope: the
# order the JAX module creates its parameters (TorchLinear kernel then bias,
# TorchBatchNorm scale then bias, a convolution its kernel).
_PARAM_ORDER = {"kernel": 1, "scale": 1, "bias": 2}


def _layout(module: nn.Module) -> tuple:
    """What the draws of ``module``'s parameters depend on: (name, the
    owner's kind, the shape in the JAX layout ((*kernel, I, O) convolutions,
    (in, out) linears), the owner's fan-in) of each parameter."""
    out = []
    for name, param in module.named_parameters():
        owner = module.get_submodule(name.rpartition(".")[0])
        if isinstance(owner, (nn.BatchNorm2d, nn.BatchNorm3d)):
            kind = "norm"
        elif isinstance(owner, (nn.Conv2d, nn.Conv3d)):
            kind = "conv"
        elif isinstance(owner, nn.Linear):
            kind = "linear"
        else:
            raise TypeError(f"no JAX initializer for {name} of {type(owner).__name__}")
        shape = tuple(param.shape)
        if param.dim() >= 3:  # (O, I, *kernel) -> (*kernel, I, O)
            shape = shape[2:] + (shape[1], shape[0])
        elif param.dim() == 2:
            shape = shape[::-1]
        out.append((name, kind, shape, getattr(owner, "in_features", None)))
    return tuple(out)


def _draw_tree(key, layout: tuple) -> dict:
    leaves, requests, scales = [], [], []
    for name, kind, shape, fan_in in layout:
        path = jax_param_path(name, kind == "norm")
        leaf_key = prng.fold_in_static(key, path[:-1] + (_PARAM_ORDER[path[-1]],))
        if kind == "norm":
            leaves.append((path, (np.ones if path[-1] == "scale" else np.zeros)(shape, np.float32)))
            continue
        if kind == "conv":
            # variance_scaling(2, "fan_out", "normal"): the variance rounded
            # to float32, its float32 square root times a standard normal
            requests.append(("normal", leaf_key, shape))
            scales.append(np.sqrt(np.float32(2.0 / (shape[-1] * math.prod(shape[:-2])))))
        elif path[-1] == "kernel":  # a linear's: 1 / jnp.sqrt(fan_in), in float32
            bound = np.float32(1.0) / np.sqrt(np.float32(fan_in))
            requests.append(("uniform", leaf_key, shape, -bound, bound))
            scales.append(None)
        else:  # its bias: 1 / float(fan_in) ** 0.5 in Python, rounded by uniform
            bound = 1.0 / float(fan_in) ** 0.5
            requests.append(("uniform", leaf_key, shape, -bound, bound))
            scales.append(None)
        leaves.append((path, len(requests) - 1))
    drawn = prng.draw(requests)
    tree = {}
    for path, value in leaves:
        if isinstance(value, int):
            value = drawn[value] if scales[value] is None else drawn[value] * scales[value]
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def jax_init_tree(module: nn.Module, key) -> dict:
    """Every parameter of ``module`` as flax's ``init`` draws it under the
    key ``key``, with the JAX package's initializers
    (``models/layers.py:25-46,85-86`` there): the parameter at scope path
    ``p`` with flax's counter ``c`` takes ``fold_in_static(key, p + (c,))``
    (``flax/core/scope.py``, ``make_rng``), in the JAX layout ((*kernel, I,
    O) convolutions, (in, out) linears).  Returns the nested params tree,
    named as the JAX package names it.  The draws are made together
    (:func:`~..utils.prng.draw`)."""
    return _draw_tree(key, _layout(module))


@functools.lru_cache(maxsize=2)
def _initial_state(key_words: tuple, layout: tuple) -> dict:
    """The port's state_dict of :func:`_draw_tree`, kept for the last two
    (key, layout) pairs: the draws are a function of those alone, and each
    entry run again in one process (``run_api``, the tests, the smoke run)
    would make them again.  Read only; callers copy out of it."""
    from ..engine.checkpoint import state_dict_from_jax

    return state_dict_from_jax(_draw_tree(np.array(key_words, np.uint32), layout), {})


@torch.no_grad()
def init_parameters(module: nn.Module, key) -> None:
    """The JAX package's initialization of ``module`` under the flax key
    ``key`` (a (2,) uint32 key, :mod:`..utils.prng`): each parameter drawn
    by :func:`jax_init_tree` on the host (so a key gives the same weights on
    every device), turned into the port's layout by the checkpoint name map
    (``engine/checkpoint.py::state_dict_from_jax``); BatchNorm statistics
    start at zero mean and unit variance, the MMTM buffers at zero."""
    state = _initial_state(tuple(int(w) for w in np.asarray(key, np.uint32)), _layout(module))
    own = dict(module.named_parameters())
    if set(state) != set(own):
        raise KeyError(f"the JAX names do not map back onto the parameters: {sorted(set(state) ^ set(own))[:5]}")
    for name, value in state.items():
        own[name].copy_(value)
    for m in module.modules():
        if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.reset_running_stats()
    for name, buf in module.named_buffers():
        if ".running_avg_" in f".{name}" or name == "step" or name.endswith(".step"):
            buf.zero_()
