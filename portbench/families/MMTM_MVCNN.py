"""The two-view ResNet-18 family with MMTM fusion (``MMTM_MVCNN``): what
the harness needs of a configuration of it."""

from __future__ import annotations

from portbench.reference.nets import Arch


def arch(config):
    return Arch(2, config["views"], config["classes"], config["modality_names"], bug_compat=config["bug_compat"])


def sample_shape(config):
    """A uint8 sample: (V, H, W, C) views."""
    return (config["views"], config["image_size"], config["image_size"], config["channels"])


def spatial(config):
    return (config["image_size"], config["image_size"])


def flip_shape(batch_shape):
    """One flip a view of each sample."""
    return tuple(batch_shape[:2])


def program_model(config, device):
    """The program's model of this configuration, on ``device`` in its
    memory format, its weights not yet set."""
    import torch
    from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN

    with torch.device(device):
        model = MMTMMVCNN(nclasses=config["classes"], num_towers=config["views"],
                          modality_names=tuple(config["modality_names"]), mmtm_ratio=config["mmtm_ratio"],
                          bug_compat=config["bug_compat"], use_pallas=config["use_pallas"], dtype=torch.float32)
    return model.to(memory_format=model.memory_format)
