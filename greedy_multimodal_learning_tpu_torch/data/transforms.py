"""On-device image preprocessing (``greedy_multimodal_learning_tpu/data/transforms.py``).

uint8 -> the compute dtype; in train mode a horizontal flip per (sample,
view), as the reference's per-view RandomHorizontalFlip
(``transforms.py:24-58``); then the ImageNet normalize folded into one FMA
``x * (1/(255*std)) - mean/std``, computed in that dtype as the JAX package
does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .modelnet import IMAGENET_MEAN, IMAGENET_STD


def draw_flips(batch: int, views: int, generator: torch.Generator) -> torch.Tensor:
    """(batch, views) bool flip mask, each flip with probability 1/2, drawn
    from ``generator`` on its device (never the global RNG)."""
    return torch.rand((batch, views), generator=generator, device=generator.device) < 0.5


def preprocess(
    images_u8: torch.Tensor,
    *,
    train: bool,
    dtype=torch.float32,
    flip: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """uint8 (B, V, H, W, C) -> normalized ``dtype`` tensor on the input's
    device.  In train mode each (sample, view) image is flipped along W
    where the (B, V) bool ``flip`` is set; without ``flip`` the mask is
    drawn from ``generator`` (:func:`draw_flips`)."""
    x = images_u8.to(dtype)
    if train:
        if x.dim() != 5:
            raise NotImplementedError(f"train-time flips are ported for (B, V, H, W, C) image stacks, got {x.dim()} dims")
        if flip is None:
            if generator is None:
                raise ValueError("train preprocessing needs a flip mask or a torch.Generator")
            flip = draw_flips(x.shape[0], x.shape[1], generator)
        x = torch.where(flip.view(x.shape[0], x.shape[1], 1, 1, 1), x.flip(-2), x)
    bshape = (1,) * (x.dim() - 1) + (3,)
    scale = torch.as_tensor(1.0 / (255.0 * IMAGENET_STD), device=x.device).to(dtype).view(bshape)
    bias = torch.as_tensor(IMAGENET_MEAN / IMAGENET_STD, device=x.device).to(dtype).view(bshape)
    return x * scale - bias
