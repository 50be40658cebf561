"""Shared entry-point bootstrap: model + loaders + a seeded model on its
device (``greedy_multimodal_learning_tpu/bootstrap.py``)."""

from __future__ import annotations

import torch

from .models.layers import init_parameters


def build_model_and_loaders(model_name: str, batch_size: int, device):
    """Model-family dispatch.  This slice ports 'MMTM_MVCNN' (ModelNet40
    multiview).  Returns (model, (train, val, test) loaders), whose corpus,
    when cached, lives on ``device``."""
    if model_name != "MMTM_MVCNN":
        raise NotImplementedError(f"model {model_name!r} is not ported yet; the port has 'MMTM_MVCNN'")
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
    """Seeded initialization (on the CPU, so a seed gives the same weights
    on every device), then move to ``device`` in channels-last memory and
    switch to eval mode."""
    init_parameters(model, torch.Generator().manual_seed(int(seed)))
    return model.to(device=resolve_device(device), memory_format=torch.channels_last).eval()
