"""The three-modality r3d-18 family with MMTM fusion (``MMTM_3DCNN``):
what the harness needs of a configuration of it."""

from __future__ import annotations

from portbench.reference.nets import Arch


def arch(config):
    return Arch(3, config["modalities"], config["classes"], config["modality_names"],
                width_multiplier=config["width_multiplier"], bug_compat=config["bug_compat"])


def sample_shape(config):
    """A uint8 sample: (M, T, H, W, C) clips."""
    return (config["modalities"], config["frames"], config["image_size"], config["image_size"], config["channels"])


def spatial(config):
    return (config["frames"], config["image_size"], config["image_size"])


def flip_shape(batch_shape):
    """One flip a sample, shared by its modalities."""
    return tuple(batch_shape[:1])


def program_model(config, device):
    """The program's model of this configuration, on ``device`` in its
    memory format, its weights not yet set."""
    import torch
    from greedy_multimodal_learning_tpu_torch.models import MMTM3DCNN

    with torch.device(device):
        model = MMTM3DCNN(nclasses=config["classes"], num_towers=config["modalities"],
                          modality_names=tuple(config["modality_names"]), mmtm_ratio=config["mmtm_ratio"],
                          bug_compat=config["bug_compat"], width_multiplier=config["width_multiplier"],
                          dtype=torch.float32)
    return model.to(memory_format=model.memory_format)
