"""Trunk + MMTM fusion forward (``greedy_multimodal_learning_tpu/models/fusion.py``):
per-tower layer groups 2..4, each followed by MMTM fusion, then
avgpool→fc heads and the blend of the per-tower logits."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# Fusion sits after layer groups 2/3/4 at these trunk widths.
FUSION_WIDTHS = {2: 128, 3: 256, 4: 512}


def fused_towers_forward(
    towers,
    mmtms,
    feats,
    *,
    curation_mode,
    caring_modality,
    train: bool,
    valid_mask,
    mmtm_off: bool = False,
    average_squeezemaps: Optional[Sequence] = None,
    saving_scales: bool = False,
    saving_squeezes: bool = False,
    mmtm_state: Optional[dict] = None,
):
    """Run layer groups 2..4 + fusion + heads over per-tower ``feats`` (the
    outputs of stem+layer1).  ``mmtms`` maps layer group -> MMTM module.
    ``average_squeezemaps`` (read with ``mmtm_off``) has the analysis
    pipeline's 4 slots: slot 0 unused, slots 1..3 for mmtm2..mmtm4
    (``fusion.py:40-56``).
    With ``mmtm_state`` given, each MMTM writes its new running state there
    under its own name (``mmtm2`` ...) instead of into its buffers.

    Returns (blend_logits, [per-tower logits], scales, squeezed_mps)."""
    n = len(towers)
    scales = []
    squeezed_mps = []
    for li in (2, 3, 4):
        feats = [towers[i].layer(li, feats[i], train, valid_mask) for i in range(n)]
        feats, scale, squeezed = mmtms[li](
            feats,
            curation_mode=curation_mode,
            caring_modality=caring_modality,
            turnoff_cross_modal_flow=mmtm_off,
            average_squeezemaps=average_squeezemaps[li - 1] if mmtm_off else None,
            valid_mask=valid_mask,
            return_scale=saving_scales,
            return_squeezed_mps=saving_squeezes,
            state_out=None if mmtm_state is None else mmtm_state.setdefault(f"mmtm{li}", {}),
        )
        scales.append(scale)
        squeezed_mps.append(squeezed)

    logits = [towers[i].head(feats[i]).to(torch.float32) for i in range(n)]
    blend = sum(logits) / float(n)
    return blend, logits, scales, squeezed_mps
