"""3D ResNet-18 trunk (r3d-18) with the split ``stem`` / ``layer(i)`` /
``head`` API (``greedy_multimodal_learning_tpu/models/resnet3d.py``).

The 2-D trunk's design in three dimensions: a (3, 7, 7) stem with stride
(1, 2, 2) and no max-pool, 3³ convolutions in the blocks, a 1³ downsample
in the first block of layer groups 2-4.  Module names are the 2-D trunk's
(``conv1``, ``bn1``, ``layer{g}.{k}``, ``downsample.0/1``, ``fc``), which is
the state_dict naming the JAX package writes for this family too
(``engine/checkpoint.py:68-82``).  Activations are (B, C, T, H, W) tensors
in ``torch.channels_last_3d`` memory, the JAX package's (B, T, H, W, C)
layout underneath.  ``remat`` recomputes each block's activations in the
backward pass, as the 2-D trunk's (``resnet3d.py:73``).
"""

from __future__ import annotations

from torch import nn

from .layers import BatchNorm3d, Conv3d, Linear
from .resnet import BasicBlock, ResNet18Trunk


class BasicBlock3D(nn.Module):
    def __init__(self, cin, cout, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv3d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm3d(cout)
        self.conv2 = Conv3d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm3d(cout)
        self.downsample = nn.Sequential(Conv3d(cin, cout, 1, stride, 0, bias=False), BatchNorm3d(cout)) if (
            downsample) else None

    forward = BasicBlock.forward


class ResNet3D18Trunk(nn.Module):
    """Stem + 4 layer groups + global-average head of r3d-18 at
    ``width_multiplier`` times the published widths, each stage callable
    separately for fusion interleaving; input (B, 3, T, H, W)."""

    WIDTHS = ResNet18Trunk.WIDTHS

    def __init__(self, nclasses: int = 25, width_multiplier: float = 1.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        w = lambda c: int(c * width_multiplier)
        self.conv1 = Conv3d(3, w(64), (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=False)
        self.bn1 = BatchNorm3d(w(64))
        cin = w(64)
        for li, width in enumerate(w(c) for c in self.WIDTHS):
            stride = 1 if li == 0 else 2
            blocks = [BasicBlock3D(cin, width, stride, downsample=li > 0), BasicBlock3D(width, width)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            cin = width
        self.fc = Linear(cin, nclasses)

    def stem(self, x, train: bool = False, mask=None):
        return self.bn1(self.conv1(x), train, mask, relu=True)

    layer = ResNet18Trunk.layer
    head = ResNet18Trunk.head
