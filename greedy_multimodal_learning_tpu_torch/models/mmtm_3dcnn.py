"""MMTM_3DCNN — the N-modality 3D-CNN classifier with MMTM fusion
(``greedy_multimodal_learning_tpu/models/mmtm_3dcnn.py``): RGB, depth and
optical-flow clips through r3d-18 towers (``resnet3d.py``), fused by MMTM
after layer groups 2/3/4 at ``width_multiplier`` × 128/256/512 (ratio 4),
global-average heads, blended logits ``mean(per-modality logits)``.

The gating is the eager N-modality path of ``mmtm.py``, as in the JAX
package: this family never sets ``use_pallas`` (``mmtm_3dcnn.py:33,99-115``),
and the kernels take two modalities only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import config as cfg
from .fusion import FUSION_WIDTHS, fused_towers_forward
from .mmtm import MMTM
from .mvcnn import compute_dtype
from .resnet3d import ResNet3D18Trunk

DEFAULT_MODALITY_NAMES = ("rgb", "depth", "flow")


class MMTM3DCNN(nn.Module):
    """N-tower r3d-18 + MMTM fusion model.  Submodules are named
    ``net_view_<i>`` and ``mmtm<2|3|4>`` as in the JAX package."""

    #: the memory format of its weights and maps
    memory_format = torch.channels_last_3d

    def __init__(
        self,
        nclasses: int = 25,
        num_towers: int = 3,
        modality_names: Sequence[str] = DEFAULT_MODALITY_NAMES,
        mmtm_ratio: float = 4.0,
        bug_compat: bool = False,
        width_multiplier: float = 1.0,
        saving_mmtm_scales: bool = False,
        saving_mmtm_squeeze_array: bool = False,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        self.num_towers = num_towers
        self.modality_names = tuple(modality_names)
        self.saving_mmtm_scales = saving_mmtm_scales
        self.saving_mmtm_squeeze_array = saving_mmtm_squeeze_array
        self.dtype = dtype
        for i in range(num_towers):
            setattr(self, f"net_view_{i}", ResNet3D18Trunk(nclasses, width_multiplier, remat=remat))
        for li, width in FUSION_WIDTHS.items():
            mmtm = MMTM(
                dims=[int(width * width_multiplier)] * num_towers,
                ratio=mmtm_ratio,
                modality_names=self.modality_names,
                bug_compat=bug_compat,
            )
            setattr(self, f"mmtm{li}", mmtm)

    @property
    def towers(self):
        return [getattr(self, f"net_view_{i}") for i in range(self.num_towers)]

    @property
    def mmtms(self):
        return {li: getattr(self, f"mmtm{li}") for li in FUSION_WIDTHS}

    def forward(
        self,
        x,
        curation_mode=None,
        caring_modality=None,
        *,
        train: bool = False,
        valid_mask: Optional[torch.Tensor] = None,
        mmtm_state: Optional[dict] = None,
        mmtm_off: bool = False,
        average_squeezemaps: Optional[Sequence] = None,
    ):
        """x: a stacked (B, num_towers, T, H, W, C) clip tensor or a list of
        per-modality (B, T, H, W, C) clips (``mmtm_3dcnn.py:80-81``).
        Arguments and returns as :meth:`~.mvcnn.MMTMMVCNN.forward`."""
        clips = list(x) if isinstance(x, (list, tuple)) else [x[:, i] for i in range(self.num_towers)]
        feats = []
        for tower, clip in zip(self.towers, clips):
            xi = clip.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(memory_format=self.memory_format)
            feats.append(tower.layer(1, tower.stem(xi, train, valid_mask), train, valid_mask))
        return fused_towers_forward(
            self.towers,
            self.mmtms,
            feats,
            curation_mode=curation_mode,
            caring_modality=caring_modality,
            train=train,
            valid_mask=valid_mask,
            mmtm_off=mmtm_off,
            average_squeezemaps=average_squeezemaps,
            saving_scales=self.saving_mmtm_scales,
            saving_squeezes=self.saving_mmtm_squeeze_array,
            mmtm_state=mmtm_state,
        )


def build_3dcnn_from_config(dtype=None) -> MMTM3DCNN:
    """Construct the model from the ``MMTM_3DCNN`` gin surface
    (``mmtm_3dcnn.py:99-115``).  The MMTM options are this scope's own
    fields: ``bug_compat`` defaults to False here (the reference's bug is
    two-modality specific), and ``MMTM_mitigate`` is not read."""
    q = lambda p, d: cfg.query("MMTM_3DCNN", p, d)
    names = q("modality_names", list(DEFAULT_MODALITY_NAMES))
    return MMTM3DCNN(
        nclasses=int(q("nclasses", 25)),
        num_towers=int(q("num_modalities", len(names))),
        modality_names=tuple(names),
        mmtm_ratio=float(q("mmtm_ratio", 4.0)),
        bug_compat=bool(q("bug_compat", False)),
        width_multiplier=float(q("width_multiplier", 1.0)),
        saving_mmtm_scales=bool(q("saving_mmtm_scales", False)),
        saving_mmtm_squeeze_array=bool(q("saving_mmtm_squeeze_array", False)),
        dtype=compute_dtype("MMTM_3DCNN", dtype),
        remat=bool(q("remat", False)),
    )
