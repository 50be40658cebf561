"""Building-block layers with the JAX package's numerics
(``greedy_multimodal_learning_tpu/models/layers.py``).

Parameters and BatchNorm statistics stay float32 whatever the compute
dtype; convolution and linear weights are cast to the activation's dtype at
use, as flax's ``dtype=`` does.  BatchNorm here is eval-only: it normalizes
with the running statistics in float32 and casts back to the compute dtype
(``layers.py:94-95,118-120``).  Masked train-mode statistics come with the
training slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (no bias) whose float32 weight is cast to the input's
    dtype at use."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


def conv3x3(cin, cout, stride=1):
    return Conv2d(cin, cout, 3, stride, 1, bias=False)


def conv1x1(cin, cout, stride=1):
    return Conv2d(cin, cout, 1, stride, 0, bias=False)


class Linear(nn.Linear):
    """``TorchLinear`` (``layers.py:50-62``): the input, weight and bias are
    cast to the compute dtype and the bias is added in that dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) evaluated as
    ``TorchBatchNorm`` does with ``use_running_average=True``: the running
    statistics and affine stay float32, the normalize runs in float32 and
    the result is cast to the input's dtype (``layers.py:118-120``).
    ``F.batch_norm`` does exactly that for a bfloat16 input with float32
    statistics, in one pass."""

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "train-mode (masked) BatchNorm statistics come with the training slice; call model.eval()"
            )
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator):
    """Seeded initialization with the JAX package's initializers: kaiming
    normal fan-out for convolutions, torch's default U(±1/sqrt(fan_in)) for
    linear weights and biases, ones/zeros for BatchNorm."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
