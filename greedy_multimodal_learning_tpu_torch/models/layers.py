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
import math
import threading

import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as parallel
from ..parallel import tensor as tensor_parallel


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


class _MaskedBatchNorm:
    """``TorchBatchNorm``'s semantics (``layers.py:83-120``) for a torch
    BatchNorm (eps 1e-5, momentum 0.1) on (B, C, *spatial) maps; the
    explicit ``train`` argument, not ``self.training``, selects the
    statistics, as in the JAX package.

    * ``train=False``: the running statistics, in one ``F.batch_norm`` pass
      (float32 statistics and affine, float32 normalize, the result in the
      input's dtype, as ``layers.py:118-120``).
    * ``train=True``: batch statistics over the rows whose (B,) ``mask`` is
      non-zero (all rows without a mask) and every spatial position, in
      float32; the normalize uses the biased variance, the running variance
      takes the unbiased one ``var * n / max(n - 1, 1)``.  ``F.batch_norm``
      cannot mask, so this is plain torch ops.  A :func:`rematerialize` recompute
      does not update the running statistics a second time.  Under data
      parallelism both passes' sums, and the count, are the data group's."""

    def forward(self, x, train: bool = False, mask=None):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        xf = x.float()
        dims = (0,) + tuple(range(2, x.dim()))
        per_channel = (1, -1) + (1,) * (x.dim() - 2)
        m = torch.ones(x.shape[0], device=x.device) if mask is None else mask.float()
        m = m.view((-1,) + (1,) * (x.dim() - 1))
        n = m.sum() * math.prod(x.shape[2:])
        total = (xf * m).sum(dim=dims)
        world = parallel.active()
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
        y = centered * inv.view(per_channel) + self.bias.view(per_channel)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var, n):
        unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
        self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
        self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased)


class BatchNorm2d(_MaskedBatchNorm, nn.BatchNorm2d):
    """The masked BatchNorm on (B, C, H, W) maps."""


class BatchNorm3d(_MaskedBatchNorm, nn.BatchNorm3d):
    """The masked BatchNorm on (B, C, T, H, W) maps."""


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator):
    """Seeded initialization with the JAX package's initializers: kaiming
    normal fan-out for 2-D and 3-D convolutions (on an (O, I, *kernel)
    weight the variance of flax's ``variance_scaling(2, "fan_out")`` on its
    (*kernel, I, O) kernel), torch's default U(±1/sqrt(fan_in)) for linear
    weights and biases, ones/zeros for BatchNorm."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.reset_parameters()
