"""Synthetic ModelNet-shaped dataset generator for tests and smoke runs
(``greedy_multimodal_learning_tpu/data/synthetic.py``): the same files from
the same seed."""

from __future__ import annotations

import json
import os

import numpy as np

from ..models.mvcnn import MODELNET40_CLASSNAMES


def make_synthetic_modelnet(
    root_dir,
    *,
    n_train=16,
    n_test=8,
    num_views=2,
    image_size=32,
    nclasses=4,
    seed=0,
):
    """Write a metadata.json + per-model .npy view stacks in the on-disk
    layout :class:`~.modelnet.MultiviewModelNet` reads."""
    rng = np.random.default_rng(seed)
    os.makedirs(root_dir, exist_ok=True)
    classnames = MODELNET40_CLASSNAMES[:nclasses]
    meta = {"classnames": classnames, "train": [], "test": []}
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root_dir, split), exist_ok=True)
        for i in range(n):
            cls = i % nclasses
            model = f"{classnames[cls]}_{split}_{i:04d}"
            meta[split].append({"classname": classnames[cls], "model": model})
            # class-correlated patterns; brightness levels spread over
            # [20, 220] for any nclasses
            base = rng.integers(0, 255, (num_views, image_size, image_size, 3), dtype=np.uint8)
            base[:, : image_size // 2] = 20 + (cls * 200) // max(nclasses - 1, 1)
            np.save(os.path.join(root_dir, split, f"{model}.npy"), base)
    with open(os.path.join(root_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return root_dir
