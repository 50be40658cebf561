"""Shared entry-point bootstrap: model + loaders + a seeded model on its
device (``greedy_multimodal_learning_tpu/bootstrap.py``)."""

from __future__ import annotations

import torch

from .engine.train_state import train_keys
from .models.layers import init_parameters


def build_model_and_loaders(model_name: str, batch_size: int, device):
    """Model-family dispatch (``bootstrap.py:15-26``): 'MMTM_MVCNN'
    (ModelNet40 multiview) or 'MMTM_3DCNN' (RGB + depth + flow clips through
    3D-CNN towers).  Returns (model, (train, val, test) loaders), whose
    corpus, when cached, lives on ``device``."""
    if model_name == "MMTM_3DCNN":
        from .data.nvgesture import get_nvgesturedata
        from .models import build_3dcnn_from_config

        return build_3dcnn_from_config(), get_nvgesturedata(batch_size=batch_size, device=device)
    if model_name != "MMTM_MVCNN":
        raise ValueError(f"unknown model {model_name!r}; the families are 'MMTM_MVCNN' and 'MMTM_3DCNN'")
    from .data import get_mvdcndata
    from .models import build_model_from_config

    return build_model_from_config(), get_mvdcndata(batch_size=batch_size, device=device)


def select_split(loaders, name: str):
    """train/val/test loader choice."""
    train_loader, val_loader, test_loader = loaders
    table = {"train": train_loader, "val": val_loader, "test": test_loader}
    if name not in table:
        raise ValueError(f"target_data_split must be one of {sorted(table)}, got {name!r}")
    return table[name]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no quiet
    fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; bind device='cpu' to run on the CPU"
        )
    return device


def init_model(model: torch.nn.Module, seed: int, device) -> torch.nn.Module:
    """The JAX package's initialization for ``seed`` (drawn on the host,
    so a seed gives the same weights on every device:
    :func:`~.models.layers.init_parameters`), then move to ``device`` in the
    family's channels-last memory format (``model.memory_format``:
    ``channels_last`` for 4-D weights, ``channels_last_3d`` for 5-D) and
    switch to eval mode."""
    init_parameters(model, train_keys(seed)[0])
    return model.to(device=resolve_device(device), memory_format=model.memory_format).eval()
