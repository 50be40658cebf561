"""ResNet-18 trunk with the split ``stem`` / ``layer(i)`` / ``head`` API
(``greedy_multimodal_learning_tpu/models/resnet.py:78-157``).

``train`` and the (B,) validity ``mask`` reach every BatchNorm
(``resnet.py:85-96,127-146``).  Module and attribute names are
torchvision's, which is also the state_dict
naming the JAX package writes (``engine/checkpoint.py:42-82``), so a
JAX-written checkpoint loads with ``load_state_dict`` directly.  Activations
are NCHW tensors in ``torch.channels_last`` memory, so a (B, C, H, W) map is
the JAX package's (B, H, W, C) layout underneath.

Two options of the JAX package's trunk: ``stem_s2d`` and ``remat``.  The
JAX package's ``stem_s2d`` (``StemConv``, ``resnet.py:23-75``) takes the
stem's sums as a 4×4 convolution over the 2×2 space-to-depth input, a
layout for the TPU's matrix unit; it is the same function as the plain
7×7 stride-2 convolution, so the port accepts the flag, runs the plain
cuDNN stem and keeps only its refusal of odd spatial sizes.  ``remat``
recomputes each block's activations in the backward pass
(:func:`~.layers.rematerialize`, flax's ``nn.remat(BasicBlock)``,
``resnet.py:111``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d, Linear, conv1x1, conv3x3, rematerialize


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, downsample=False):
        super().__init__()
        self.conv1 = conv3x3(cin, cout, stride)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = conv3x3(cout, cout, 1)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = nn.Sequential(conv1x1(cin, cout, stride), BatchNorm2d(cout)) if downsample else None

    def forward(self, x, train: bool = False, mask=None):
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(x), train, mask)
        out = self.bn1(self.conv1(x), train, mask, relu=True)
        out = self.bn2(self.conv2(out), train, mask)
        return torch.relu(out + identity)


class ResNet18Trunk(nn.Module):
    """Stem + 4 layer groups + global-average head of torchvision resnet18,
    each stage callable separately for fusion interleaving."""

    WIDTHS = (64, 128, 256, 512)

    def __init__(self, nclasses: int = 40, stem_s2d: bool = False, remat: bool = False):
        super().__init__()
        self.stem_s2d = stem_s2d
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for li, width in enumerate(self.WIDTHS):
            stride = 1 if li == 0 else 2
            blocks = [BasicBlock(cin, width, stride, downsample=li > 0), BasicBlock(width, width)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            cin = width
        self.fc = Linear(512, nclasses)

    def stem(self, x, train: bool = False, mask=None):
        if self.stem_s2d and (x.shape[-2] % 2 or x.shape[-1] % 2):
            raise ValueError(f"space-to-depth stem needs even spatial dims, got {tuple(x.shape[-2:])}")
        x = self.bn1(self.conv1(x), train, mask, relu=True)
        return F.max_pool2d(x, 3, 2, 1)

    def layer(self, i: int, x, train: bool = False, mask=None):
        """Run layer group i (1-based, mirroring torchvision layer1..layer4).
        The blocks sit in an ``nn.Sequential`` for torchvision's state_dict
        names; they run one by one so that each gets ``train`` and ``mask``,
        each under :func:`~.layers.rematerialize` in train mode when ``remat``."""
        for block in getattr(self, f"layer{i}"):
            x = rematerialize(block, x, train, mask) if self.remat and train else block(x, train, mask)
        return x

    def head(self, x):
        """Global average pool over every spatial dim in float32, cast to the
        compute dtype, then fc (``resnet.py:148-151``)."""
        return self.fc(x.mean(dim=tuple(range(2, x.dim())), dtype=torch.float32).to(x.dtype))
