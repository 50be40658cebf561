"""On-device image preprocessing (``greedy_multimodal_learning_tpu/data/transforms.py``).

Test-time transform: uint8 -> the compute dtype, then the ImageNet
normalize folded into one FMA ``x * (1/(255*std)) - mean/std``, computed in
that dtype as the JAX package does.  Train-time flips come with the training
slice.
"""

from __future__ import annotations

import torch

from .modelnet import IMAGENET_MEAN, IMAGENET_STD


def preprocess(images_u8: torch.Tensor, *, train: bool, dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, V, ..., H, W, C) -> normalized ``dtype`` tensor on the
    input's device."""
    if train:
        raise NotImplementedError("train-time preprocessing (random flips) comes with the training slice")
    x = images_u8.to(dtype)
    bshape = (1,) * (x.dim() - 1) + (3,)
    scale = torch.as_tensor(1.0 / (255.0 * IMAGENET_STD), device=x.device).to(dtype).view(bshape)
    bias = torch.as_tensor(IMAGENET_MEAN / IMAGENET_STD, device=x.device).to(dtype).view(bshape)
    return x * scale - bias
