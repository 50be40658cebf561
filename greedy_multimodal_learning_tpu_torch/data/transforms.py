"""On-device image preprocessing (``greedy_multimodal_learning_tpu/data/transforms.py``).

uint8 -> the compute dtype; in train mode a horizontal flip per (sample,
view) of a (B, V, H, W, C) image stack, as the reference's per-view
RandomHorizontalFlip, or one flip per sample of a (B, M, T, H, W, C) clip
batch, shared across its modalities (``transforms.py:24-58``); then the
ImageNet normalize folded into one FMA ``x * (1/(255*std)) - mean/std``,
computed in that dtype as the JAX package does.  The flips are the JAX
package's draws (:func:`draw_flips`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import prng
from .modelnet import IMAGENET_MEAN, IMAGENET_STD


def flip_shape(shape) -> tuple:
    """The train flips' mask shape for a uint8 batch of ``shape``: (B,) for
    (B, M, T, H, W, C) clips, whose modalities show one scene and so share
    their flip, else (B, V) (``transforms.py:44-57``)."""
    return tuple(shape[:1]) if len(shape) >= 6 else tuple(shape[:2])


def draw_flips(shape, key) -> torch.Tensor:
    """The JAX package's flip mask of ``shape`` under the PRNG key ``key``:
    ``bernoulli(key, 0.5, shape)`` (``transforms.py:47,52``), drawn on the
    host (:mod:`..utils.prng`) as a bool CPU tensor."""
    return torch.from_numpy(prng.bernoulli(key, 0.5, tuple(shape)))


def preprocess(
    images_u8: torch.Tensor,
    *,
    train: bool,
    dtype=torch.float32,
    flip: Optional[torch.Tensor] = None,
    key=None,
) -> torch.Tensor:
    """uint8 (B, V, H, W, C) images or (B, M, T, H, W, C) clips ->
    normalized ``dtype`` tensor on the input's device.  In train mode each
    image (clip sample) is flipped along W where the bool ``flip`` of
    :func:`flip_shape` is set; without ``flip`` the mask is drawn under the
    PRNG key ``key`` (:func:`draw_flips`), as the JAX package's
    ``preprocess(..., rng=key)`` draws it."""
    x = images_u8.to(dtype)
    if train:
        shape = flip_shape(x.shape)
        if flip is None:
            if key is None:
                raise ValueError("train preprocessing needs a flip mask or a PRNG key")
            flip = draw_flips(shape, key).to(x.device)
        if tuple(flip.shape) != shape:
            raise ValueError(f"a {tuple(flip.shape)} flip mask for a {tuple(x.shape)} batch, want {shape}")
        x = torch.where(flip.view(shape + (1,) * (x.dim() - len(shape))), x.flip(-2), x)
    bshape = (1,) * (x.dim() - 1) + (3,)
    scale = torch.as_tensor(1.0 / (255.0 * IMAGENET_STD), device=x.device).to(dtype).view(bshape)
    bias = torch.as_tensor(IMAGENET_MEAN / IMAGENET_STD, device=x.device).to(dtype).view(bshape)
    return x * scale - bias
