"""Generate a modality-imbalanced synthetic ModelNet-layout dataset: the
port's copy of ``tools/make_imbalanced_modelnet.py``, which writes the same
bytes for the same arguments and takes the port's class-name table.

Real ModelNet40 is a download (the reference's data link), so the
run-level experiments use this generator, which needs none: the same on-disk
layout the reference expects (metadata.json + per-model ``<split>/<model>.npy``
12-view stacks, reference: src/dataset.py:100-121) with a controlled
modality imbalance — the exact setting the paper studies (greedy learning
favors the strong modality):

* views 0-5 ("strong"): high-contrast class-specific pattern, light noise,
* views 6-11 ("weak"): low-contrast version of the class pattern under
  heavier noise,

so the reference configs' ``specific_views = [0, 6]`` selects one strong
and one weak modality verbatim.  Per-sample random spatial shift of the
pattern prevents trivial memorization; class patterns are fixed random
codes so 40 classes stay mutually distinguishable.

Usage:
  python -m greedy_multimodal_learning_tpu_torch.experiments.imbalanced_modelnet OUT_DIR
      [--n-train 1200] [--n-test 400] [--size 112] [--nclasses 40] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..models.mvcnn import MODELNET40_CLASSNAMES


def class_patterns(nclasses: int, size: int, cells: int = 14, seed: int = 1234) -> np.ndarray:
    """Fixed per-class random block patterns in [-1, 1], (nclasses, size, size)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(-1.0, 1.0, (nclasses, cells, cells)).astype(np.float32)
    reps = size // cells
    return np.repeat(np.repeat(coarse, reps, axis=1), reps, axis=2)


def render_views(
    pattern: np.ndarray,
    rng: np.random.Generator,
    *,
    num_views: int,
    strong_contrast: float,
    weak_contrast: float,
    strong_noise: float,
    weak_noise: float,
    max_shift: int,
) -> np.ndarray:
    """(num_views, S, S, 3) uint8; first half strong renders, second half weak."""
    size = pattern.shape[0]
    views = np.empty((num_views, size, size, 3), np.uint8)
    half = num_views // 2
    for v in range(num_views):
        strong = v < half
        contrast = strong_contrast if strong else weak_contrast
        noise = strong_noise if strong else weak_noise
        dy, dx = rng.integers(-max_shift, max_shift + 1, 2)
        shifted = np.roll(np.roll(pattern, dy, axis=0), dx, axis=1)
        img = 128.0 + contrast * shifted[..., None] + rng.normal(0.0, noise, (size, size, 3))
        views[v] = np.clip(img, 0, 255).astype(np.uint8)
    return views


N_TRAIN = 1200  # train models of the default corpus (the 2-D driver's)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--n-train", type=int, default=N_TRAIN)
    ap.add_argument("--n-test", type=int, default=400)
    ap.add_argument("--size", type=int, default=112)
    ap.add_argument("--nclasses", type=int, default=40)
    ap.add_argument("--num-views", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strong-contrast", type=float, default=40.0)
    ap.add_argument("--weak-contrast", type=float, default=5.0)
    ap.add_argument("--strong-noise", type=float, default=16.0)
    ap.add_argument("--weak-noise", type=float, default=30.0)
    ap.add_argument("--max-shift", type=int, default=14)
    args = ap.parse_args(argv)

    if args.nclasses > len(MODELNET40_CLASSNAMES):
        ap.error(f"--nclasses must be <= {len(MODELNET40_CLASSNAMES)} (ModelNet40 name table)")
    rng = np.random.default_rng(args.seed)
    patterns = class_patterns(args.nclasses, args.size)
    classnames = MODELNET40_CLASSNAMES[: args.nclasses]
    meta = {"classnames": classnames, "train": [], "test": []}
    for split, n in (("train", args.n_train), ("test", args.n_test)):
        os.makedirs(os.path.join(args.out, split), exist_ok=True)
        for i in range(n):
            cls = i % args.nclasses
            model = f"{classnames[cls]}_{split}_{i:05d}"
            meta[split].append({"classname": classnames[cls], "model": model})
            stack = render_views(
                patterns[cls],
                rng,
                num_views=args.num_views,
                strong_contrast=args.strong_contrast,
                weak_contrast=args.weak_contrast,
                strong_noise=args.strong_noise,
                weak_noise=args.weak_noise,
                max_shift=args.max_shift,
            )
            np.save(os.path.join(args.out, split, f"{model}.npy"), stack)
    with open(os.path.join(args.out, "metadata.json"), "w") as f:
        json.dump(meta, f)
    print(f"wrote {args.n_train} train / {args.n_test} test models, {args.nclasses} classes -> {args.out}")


if __name__ == "__main__":
    main()
