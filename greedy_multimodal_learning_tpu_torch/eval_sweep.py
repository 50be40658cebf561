"""Multi-checkpoint evaluation entry point, the port of the repository's
``eval_sweep.py``: K checkpoints over one pass of the data
(:func:`~.engine.sweep.eval_sweep`).

    python -m greedy_multimodal_learning_tpu_torch.eval_sweep SAVE_PATH CONFIG.gin \\
        "eval_sweep_.checkpoints=['RUN/model_best_val.pt','RUN/model_last_epoch.pt']"

Checkpoint entries may be globs (``'RUN/model_*'``); the sidecars
(``.jax.pkl``, ``.torch.pt``) are never taken for checkpoints.  Writes
``SAVE_PATH/sweep.csv``, one row per checkpoint with the JAX entry's
columns, and prints the table.  Runs on the GPU (bind
``eval_sweep_.device='cpu'`` for the CPU).
"""

from __future__ import annotations

import glob
import logging
import os
import time

from . import config as cfg
from .bootstrap import build_model_and_loaders, init_model, resolve_device, select_split
from .engine.checkpoint import load_weights
from .engine.sweep import eval_sweep
from .utils import configure_logger, gin_wrap

logger = logging.getLogger(__name__)

SIDECARS = (".jax.pkl", ".torch.pt")


def checkpoint_paths(patterns):
    """Each pattern's matches, sorted, sidecars left out; a pattern that
    matches nothing raises FileNotFoundError."""
    paths = []
    for pattern in patterns:
        hits = sorted(p for p in glob.glob(pattern) if not p.endswith(SIDECARS))
        if not hits:
            raise FileNotFoundError(f"no checkpoint matches {pattern!r}")
        paths.extend(hits)
    if not paths:
        raise ValueError("eval_sweep_.checkpoints is empty: nothing to evaluate")
    return paths


@cfg.configurable
def eval_sweep_(
    save_path,
    checkpoints=(),
    target_data_split="test",
    batch_size=128,
    seed=777,
    model="MMTM_MVCNN",
    device="cuda",
):
    """Evaluate every checkpoint in ``checkpoints`` over one data pass; each
    loads non-strictly into the same seeded initialization.  Returns the
    path of ``sweep.csv``."""
    paths = checkpoint_paths(checkpoints)
    device = resolve_device(device)
    net, loaders = build_model_and_loaders(model, batch_size, device)
    target = select_split(loaders, target_data_split)
    net = init_model(net, seed, device)
    fresh = {k: v.clone() for k, v in net.state_dict().items()}
    states = []
    for p in paths:
        net.load_state_dict(fresh)
        load_weights(net, p)
        states.append({k: v.clone() for k, v in net.state_dict().items()})

    t0 = time.time()
    results = eval_sweep(net, states, target)
    dt = time.time() - t0
    n = target.num_samples
    print(f"sweep: {len(paths)} checkpoints x {n} samples in one pass, {dt:.3f}s ({n / max(dt, 1e-9):.1f} samples/s)")

    os.makedirs(save_path, exist_ok=True)
    csv_path = os.path.join(save_path, "sweep.csv")
    metric_keys = sorted(results[0])
    with open(csv_path, "w") as f:
        f.write("checkpoint," + ",".join(metric_keys) + "\n")
        for p, res in zip(paths, results):
            f.write(p + "," + ",".join(f"{res[k]:.6f}" for k in metric_keys) + "\n")
    print(f"{'checkpoint':60s} " + " ".join(f"{k:>12s}" for k in metric_keys))
    for p, res in zip(paths, results):
        print(f"{p[-60:]:60s} " + " ".join(f"{res[k]:12.4f}" for k in metric_keys))
    print(f"-> {csv_path}")
    return csv_path


if __name__ == "__main__":
    configure_logger("")
    gin_wrap(eval_sweep_)
