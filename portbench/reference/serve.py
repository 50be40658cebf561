"""Plain scoring of a batch: the evaluation forward on the running
BatchNorm statistics, with no curation, and the probabilities of the mean
of the per-modality logits."""

from __future__ import annotations

import torch

from . import nets


@torch.no_grad()
def score(arch, state, images_u8):
    """(per-modality logits, probabilities) of a uint8 batch, float32."""
    mask = torch.ones(images_u8.shape[0], device=images_u8.device)
    logits, _ = nets.forward(arch, state, nets.normalize(images_u8), train=False, mask=mask)
    blend = sum(logits) / len(logits)
    return logits, torch.softmax(blend, dim=-1)
