"""NVGesture-style multimodal clip dataset source
(``greedy_multimodal_learning_tpu/data/nvgesture.py``), in the ModelNet40
layout:

* ``metadata.json``: {classnames, train: [{classname, model}], test: [...]},
* ``root/<split>/<model>.npy``: an (M, T, H, W, C) clip stack, one leading
  entry per modality; float clips in [0, 1] are rescaled to uint8,
* ``specific_modalities`` picks a subset of modalities,
* the train/val split is ``reference_val_split``'s.

Batches are (B, M, T, H, W, C) uint8 stacks that feed ``MMTM3DCNN``
directly; :func:`get_nvgesturedata` puts each split's corpus on the device
by default, as ``get_mvdcndata`` does.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .. import config as cfg
from .modelnet import reference_val_split


class MultimodalClipDataset:
    """Map-style clip dataset."""

    def __init__(self, root_dir, split, specific_modalities: Optional[Sequence[int]] = None, cache: bool = True):
        self.root_dir = Path(root_dir)
        with open(self.root_dir / "metadata.json") as f:
            self.metadata = json.load(f)
        self.samples = self.metadata[split]
        self.classnames = self.metadata["classnames"]
        self.split = split
        self.specific_modalities = list(specific_modalities) if specific_modalities is not None else None
        self._cache = {} if cache else None

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        """Returns (idx, (M, T, H, W, C) uint8 clips, class_id)."""
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        sample = self.samples[idx]
        class_id = self.classnames.index(sample["classname"])
        clips = np.load(self.root_dir / self.split / f"{sample['model']}.npy")
        if self.specific_modalities is not None:
            clips = clips[self.specific_modalities]
        if clips.dtype != np.uint8:
            # floats in [0, 1] rescale, as the ModelNet source's do; a bare
            # astype would truncate them all to zero
            if clips.dtype.kind == "f" and clips.max() <= 1.0 + 1e-6:
                clips = (clips * 255.0).round()
            clips = np.clip(clips, 0, 255).astype(np.uint8)
        item = (idx, clips, class_id)
        if self._cache is not None:
            self._cache[idx] = item
        return item


@cfg.configurable
def get_nvgesturedata(
    root_dir=None,
    valid_size=0.2,
    batch_size=8,
    random_seed_for_validation=10,
    num_modalities=3,
    specific_modalities=None,
    seed=777,
    cache=True,
    device_cache="auto",
    device="cpu",
):
    """Loader factory with the JAX package's gin surface
    (``nvgesture.py:79-117``): the deterministic validation split, the train
    split shuffled; returns (train, valid, test) batch iterators over this
    node's share of each split.  The node's share, ``device_cache`` and
    ``device`` as in :func:`~.modelnet.get_mvdcndata`; the entries pass
    their own device."""
    from ..parallel.multihost import node_of_process, process_local_indices
    from .pipeline import BatchPipeline, wrap_device_cache

    if root_dir is None:
        root_dir = os.environ.get("DATA_DIR", ".")
    mods = specific_modalities if specific_modalities is not None else list(range(num_modalities))
    test_ds = MultimodalClipDataset(root_dir, "test", specific_modalities=mods, cache=cache)
    train_ds = MultimodalClipDataset(root_dir, "train", specific_modalities=mods, cache=cache)
    training_idx, valid_idx = reference_val_split(len(train_ds), valid_size, random_seed_for_validation)
    # each node reads its share of every split (one node: all of it)
    node = node_of_process()
    training_idx, valid_idx = process_local_indices(training_idx, *node), process_local_indices(valid_idx, *node)
    test_idx = process_local_indices(range(len(test_ds)), *node)

    train_loader = BatchPipeline(train_ds, training_idx, batch_size, shuffle=True, seed=seed)
    valid_loader = BatchPipeline(train_ds, valid_idx, batch_size, shuffle=False)
    test_loader = BatchPipeline(test_ds, test_idx, batch_size, shuffle=False)
    return tuple(wrap_device_cache(p, device_cache, device) for p in (train_loader, valid_loader, test_loader))


def make_synthetic_nvgesture(
    root_dir,
    *,
    n_train=12,
    n_test=6,
    num_modalities=3,
    frames=4,
    image_size=16,
    nclasses=4,
    seed=0,
):
    """Write a metadata.json + per-clip .npy stacks in the layout
    :class:`MultimodalClipDataset` reads: the JAX package's files, byte for
    byte, from the same arguments."""
    rng = np.random.default_rng(seed)
    os.makedirs(root_dir, exist_ok=True)
    classnames = [f"gesture_{i}" for i in range(nclasses)]
    meta = {"classnames": classnames, "train": [], "test": []}
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root_dir, split), exist_ok=True)
        for i in range(n):
            cls = i % nclasses
            model = f"{classnames[cls]}_{split}_{i:04d}"
            meta[split].append({"classname": classnames[cls], "model": model})
            clip = rng.integers(0, 255, (num_modalities, frames, image_size, image_size, 3), dtype=np.uint8)
            # class-keyed brightness spread over [20, 220] for any nclasses
            clip[:, :, : image_size // 2] = 20 + (cls * 200) // max(nclasses - 1, 1)
            np.save(os.path.join(root_dir, split, f"{model}.npy"), clip)
    with open(os.path.join(root_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return root_dir
