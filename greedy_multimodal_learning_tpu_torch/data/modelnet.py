"""ModelNet40 multi-view dataset source (``greedy_multimodal_learning_tpu/data/modelnet.py``).

* the dataset root holds ``metadata.json`` with ``train``/``test`` sample
  lists ({classname, model}) and ``classnames``,
* each sample is ``root/<split>/<model>.npy``, a (num_views, H, W, C) uint8
  stack; files written with ``torch.save`` despite the suffix are read too,
* ``specific_view`` selects a subset of views (``csrc/fastio.cc``'s view
  gather),
* the train/val split is the seed-10 ``random.Random`` shuffle, exactly.

The source yields raw uint8 host arrays; normalization runs on the device
(``data/transforms.py``).  :func:`get_mvdcndata` puts each split's corpus
on the device by default (``data/pipeline.py::DeviceCachePipeline``).
"""

from __future__ import annotations

import json
import logging
import os
import random
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .. import config as cfg
from ..utils.native import gather_views_u8

logger = logging.getLogger(__name__)

# ImageNet normalization.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_uint8_hwc(arr) -> np.ndarray:
    """Normalize a loaded per-view image stack to (V, H, W, C) uint8."""
    a = np.asarray(arr)
    if a.ndim == 3:  # (V, H, W) grayscale -> replicate channels
        a = np.repeat(a[..., None], 3, axis=-1)
    if a.ndim != 4:
        raise ValueError(f"Expected 3D/4D view stack, got {a.shape}")
    if a.shape[1] in (1, 3) and a.shape[-1] not in (1, 3):
        a = np.transpose(a, (0, 2, 3, 1))  # (V, C, H, W) -> (V, H, W, C)
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    if a.dtype != np.uint8:
        if a.dtype.kind == "f" and a.max() <= 1.0 + 1e-6:
            a = (a * 255.0).round()
        a = np.clip(a, 0, 255).astype(np.uint8)
    return a


def load_view_stack(path) -> np.ndarray:
    """Read a per-model view stack: real .npy, or a torch-serialized tensor."""
    try:
        return _to_uint8_hwc(np.load(path, allow_pickle=False))
    except (ValueError, OSError):
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(obj, "numpy"):
            obj = obj.numpy()
        return _to_uint8_hwc(obj)


class MultiviewModelNet:
    """Map-style multiview dataset."""

    def __init__(self, root_dir, split, specific_view: Optional[Sequence[int]] = None, cache: bool = True):
        self.root_dir = Path(root_dir)
        with open(self.root_dir / "metadata.json") as f:
            self.metadata = json.load(f)
        self.samples = self.metadata[split]
        self.classnames = self.metadata["classnames"]
        self.split = split
        self.specific_view = list(specific_view) if specific_view is not None else None
        self._cache = {} if cache else None

    def __len__(self):
        return len(self.samples)

    def num_views(self):
        return len(self.specific_view) if self.specific_view else None

    def __getitem__(self, idx):
        """Returns (idx, (V, H, W, C) uint8 views, class_id)."""
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        sample = self.samples[idx]
        class_id = self.classnames.index(sample["classname"])
        imgs = load_view_stack(self.root_dir / self.split / f"{sample['model']}.npy")
        if self.specific_view is not None:
            imgs = gather_views_u8(imgs, self.specific_view)
        item = (idx, imgs, class_id)
        if self._cache is not None:
            self._cache[idx] = item
        return item


def reference_val_split(num_train: int, valid_size: float, random_seed_for_validation: int = 10):
    """The deterministic val split: shuffle range(n) with a dedicated
    random.Random(seed); the first floor(valid_size*n) indices are
    validation."""
    if not 0 <= valid_size <= 1:
        raise ValueError("[!] valid_size should be in the range [0, 1].")
    indices = list(range(num_train))
    split = int(np.floor(valid_size * num_train))
    random.Random(random_seed_for_validation).shuffle(indices)
    training_idx, valid_idx = indices[split:], indices[:split]
    return training_idx, valid_idx


@cfg.configurable
def get_mvdcndata(
    ending=".png",
    root_dir=None,
    make_npy_files=False,
    valid_size=0.2,
    batch_size=8,
    random_seed_for_validation=10,
    num_views=12,
    num_workers=0,
    specific_views=None,
    seed=777,
    use_cuda=True,
    cache=True,
    device_cache="auto",
    device="cpu",
):
    """Loader factory with the JAX package's gin surface
    (``modelnet.py:128-176``).  Returns (train, valid, test) batch
    iterators over this node's share of each split
    (:func:`~..parallel.process_local_indices`; all of it on one node).

    ``device_cache``: True / False / "auto" (the default; as True): upload
    each split's uint8 corpus to ``device`` once and gather every batch
    there (:class:`~.pipeline.DeviceCachePipeline`; a corpus over the memory
    budget streams instead, with a warning); False streams host batches.
    The entries pass their own device."""
    from ..parallel.multihost import node_of_process, process_local_indices
    from .pipeline import BatchPipeline, wrap_device_cache

    if root_dir is None:
        root_dir = os.environ.get("DATA_DIR", ".")

    views = specific_views if specific_views is not None else list(range(num_views))
    test_ds = MultiviewModelNet(root_dir, "test", specific_view=views, cache=cache)
    train_ds = MultiviewModelNet(root_dir, "train", specific_view=views, cache=cache)

    training_idx, valid_idx = reference_val_split(len(train_ds), valid_size, random_seed_for_validation)
    # each node reads its share of every split (one node: all of it)
    node = node_of_process()
    training_idx, valid_idx = process_local_indices(training_idx, *node), process_local_indices(valid_idx, *node)
    test_idx = process_local_indices(range(len(test_ds)), *node)

    train_loader = BatchPipeline(train_ds, training_idx, batch_size, shuffle=True, seed=seed)
    valid_loader = BatchPipeline(train_ds, valid_idx, batch_size, shuffle=False)
    test_loader = BatchPipeline(test_ds, test_idx, batch_size, shuffle=False)
    return tuple(wrap_device_cache(p, device_cache, device) for p in (train_loader, valid_loader, test_loader))
