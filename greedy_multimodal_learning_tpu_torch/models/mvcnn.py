"""MMTM_MVCNN — N-tower multi-view CNN with MMTM fusion at three depths
(``greedy_multimodal_learning_tpu/models/mvcnn.py``): per-view ResNet-18
towers, MMTM fusion after layer groups 2/3/4 at widths 128/256/512 (ratio
4), global-average heads, blended logits ``mean(per-view logits)``.

The input keeps the JAX package's (B, num_towers, H, W, C) layout; each
tower runs on NCHW maps in ``torch.channels_last`` memory.

``MMTM_MVCNN.pretraining=True`` starts every tower from the trunk of a
local torchvision ResNet-18 state_dict (:func:`resolve_pretrained_path`,
:func:`apply_pretrained_trunks`; ``mvcnn.py:126-190``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
from torch import nn

from .. import config as cfg
from .fusion import FUSION_WIDTHS, fused_towers_forward
from .mmtm import MMTM, mmtm_config_kwargs
from .resnet import ResNet18Trunk

# ModelNet40 class names.
MODELNET40_CLASSNAMES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl", "car", "chair",
    "cone", "cup", "curtain", "desk", "door", "dresser", "flower_pot", "glass_box",
    "guitar", "keyboard", "lamp", "laptop", "mantel", "monitor", "night_stand",
    "person", "piano", "plant", "radio", "range_hood", "sink", "sofa", "stairs",
    "stool", "table", "tent", "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]

DEFAULT_MODALITY_NAMES = ("visual", "skeleton")


class MMTMMVCNN(nn.Module):
    """N-tower ResNet-18 + MMTM fusion model.  Submodules are named
    ``net_view_<i>`` and ``mmtm<2|3|4>`` as in the JAX package."""

    #: the memory format of its weights and maps
    memory_format = torch.channels_last

    def __init__(
        self,
        nclasses: int = 40,
        num_towers: int = 2,
        modality_names: Sequence[str] = DEFAULT_MODALITY_NAMES,
        mmtm_ratio: float = 4.0,
        SEonly: bool = False,
        shareweight: bool = False,
        bug_compat: bool = True,
        use_pallas: bool = False,
        saving_mmtm_scales: bool = False,
        saving_mmtm_squeeze_array: bool = False,
        dtype: torch.dtype = torch.float32,
        stem_s2d: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.num_towers = num_towers
        self.modality_names = tuple(modality_names)
        self.saving_mmtm_scales = saving_mmtm_scales
        self.saving_mmtm_squeeze_array = saving_mmtm_squeeze_array
        self.dtype = dtype
        for i in range(num_towers):
            setattr(self, f"net_view_{i}", ResNet18Trunk(nclasses, stem_s2d=stem_s2d, remat=remat))
        for li, w in FUSION_WIDTHS.items():
            mmtm = MMTM(
                dims=[w] * num_towers,
                ratio=mmtm_ratio,
                modality_names=self.modality_names,
                SEonly=SEonly,
                shareweight=shareweight,
                bug_compat=bug_compat,
                use_pallas=use_pallas,
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
        """x: (B, num_towers, H, W, C) image stack.

        ``train`` selects batch statistics (masked by ``valid_mask``) in
        every BatchNorm, as ``mvcnn.py:97-118`` of the JAX package does.
        Returns (blend_logits, [per-view logits], scales, squeezed_mps).
        ``mmtm_state``, ``mmtm_off`` and ``average_squeezemaps``: see
        :func:`~.fusion.fused_towers_forward`."""
        x = x.to(self.dtype)
        towers = self.towers
        feats = []
        for i, tower in enumerate(towers):
            xi = x[:, i].permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format)
            feats.append(tower.layer(1, tower.stem(xi, train, valid_mask), train, valid_mask))
        return fused_towers_forward(
            towers,
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


def compute_dtype(scope: str, dtype=None) -> torch.dtype:
    """``dtype`` (a torch dtype or its name), else the scope's
    ``compute_dtype`` binding (default float32), as a floating torch dtype."""
    name = cfg.query(scope, "compute_dtype", "float32") if dtype is None else dtype
    torch_dtype = getattr(torch, name) if isinstance(name, str) else name
    if not isinstance(torch_dtype, torch.dtype) or not torch_dtype.is_floating_point:
        raise ValueError(f"{scope}.compute_dtype must name a floating torch dtype, got {name!r}")
    return torch_dtype


def resolve_pretrained_path():
    """The trunk weights of ``MMTM_MVCNN.pretraining=True``: the path bound to
    ``MMTM_MVCNN.pretrained_weights_path``, else the
    ``GML_PRETRAINED_RESNET18`` environment variable (nothing is
    downloaded).  None when pretraining is off; raises when it is on with no
    path or a missing file (``mvcnn.py:126-151``)."""
    if not cfg.query("MMTM_MVCNN", "pretraining", False):
        return None
    path = cfg.query("MMTM_MVCNN", "pretrained_weights_path", None) or os.environ.get("GML_PRETRAINED_RESNET18")
    if not path:
        raise NotImplementedError(
            "MMTM_MVCNN.pretraining=True needs local torchvision resnet18 weights "
            "(this environment cannot download them): set the gin binding "
            "MMTM_MVCNN.pretrained_weights_path or the GML_PRETRAINED_RESNET18 env var"
        )
    if not os.path.exists(path):
        raise FileNotFoundError(f"pretrained trunk weights not found: {path}")
    return path


@torch.no_grad()
def apply_pretrained_trunks(model, path, num_towers):
    """Load a torchvision resnet18 state_dict (bare, or under ``state_dict``
    or ``model``; read with ``weights_only=True``) into the trunk of every
    tower ``net_view_<i>``: each starts from the same trunk, its ``fc`` head
    keeps its initialization (``mvcnn.py:154-189``).  Keys a tower lacks are
    ignored; a shape mismatch, or a file that matches no key, raises."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    trunk = {k: v for k, v in sd.items() if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    for i in range(num_towers):
        _, unexpected = getattr(model, f"net_view_{i}").load_state_dict(trunk, strict=False)
        if len(unexpected) == len(trunk):
            raise ValueError(f"{path}: none of its {len(trunk)} trunk entries names a parameter of net_view_{i}")
    return model


def build_model_from_config(dtype=None) -> MMTMMVCNN:
    """Construct the model from the ``MMTM_MVCNN`` and ``MMTM_mitigate`` gin
    surface (``mvcnn.py:192-218``).  ``pretraining`` is checked here (a
    missing path or file raises early) and applied by the entries after the
    seeded initialization."""
    q = lambda p, d: cfg.query("MMTM_MVCNN", p, d)
    resolve_pretrained_path()
    mk = mmtm_config_kwargs()
    num_towers = int(q("num_views", 2))
    names = cfg.query("Bias_Mitigation_Strong", "MMTMnames", None) or list(DEFAULT_MODALITY_NAMES)
    if len(names) != num_towers:
        names = list(DEFAULT_MODALITY_NAMES) if num_towers == 2 else [f"modal_{i}" for i in range(num_towers)]
    torch_dtype = compute_dtype("MMTM_MVCNN", dtype)
    return MMTMMVCNN(
        nclasses=int(q("nclasses", 40)),
        num_towers=num_towers,
        modality_names=tuple(names),
        SEonly=mk["SEonly"],
        shareweight=mk["shareweight"],
        bug_compat=mk["bug_compat"],
        use_pallas=mk["use_pallas"],
        saving_mmtm_scales=bool(q("saving_mmtm_scales", False)),
        saving_mmtm_squeeze_array=bool(q("saving_mmtm_squeeze_array", False)),
        dtype=torch_dtype,
        stem_s2d=bool(q("stem_s2d", False)),
        remat=bool(q("remat", False)),
    )
