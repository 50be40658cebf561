"""Whether running a suite in shards changes its runs.

One 2-D run (random arm, seed 777: a seed of the JAX summary that the port
also ran alone) trains its first epochs (``EPOCHS``) on the card under
cuDNN's deterministic algorithms, in ten processes:

* ``alone0`` and ``alone1``, one after the other, each alone on the card
  with the environment as it is (as a driver run alone trains);
* ``side0`` ... ``side7``, all at once, each with ``OMP_NUM_THREADS=1`` (as
  ``shards run --shards 8`` trains on 8 cores).

Each history is compared with ``alone0``'s, column by column, the timing
columns left out.  Every train process writes the TF32 switches, the cuDNN
flags and the thread count it trained under into its run directory, read
inside that process after training; the report holds them.

Usage:  python -m greedy_multimodal_learning_tpu_torch.experiments.shard_check WORKDIR

Prints, last, one JSON line: each run's comparison, its switches and its wall
seconds.  Exits 1 without a card or when a train process fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

from . import northstar
from .common import REPO, read_history

ARM, SEED = "random", 777
EPOCHS = 10  # training_loop.n_epochs: 9 epochs run
SIDE_BY_SIDE = 8
TIMING = ("time", "epoch_begin_time", "train_samples_per_sec")
MODULE = "greedy_multimodal_learning_tpu_torch.experiments.shard_check"


def compare_histories(a, b):
    """Two histories ({column: values}) against each other: whether every
    column but the timing ones holds the same values, and each such
    column's largest absolute difference (NaN equal to NaN)."""
    columns = [c for c in a if c not in TIMING]
    if sorted(columns) != sorted(c for c in b if c not in TIMING) or len(a["epoch"]) != len(b["epoch"]):
        return {"identical": False, "epochs": [len(a["epoch"]), len(b["epoch"])], "max_abs_diff": None}
    diff = {}
    for c in columns:
        both = [(x, y) for x, y in zip(a[c], b[c]) if not (math.isnan(x) and math.isnan(y))]
        diff[c] = max((abs(x - y) for x, y in both), default=0.0)
    return {"identical": not any(diff.values()), "epochs": [len(a["epoch"])] * 2, "max_abs_diff": diff}


def train_one(workdir):
    """The run's train phase in this process, deterministic cuDNN; its
    switches written to ``<run>/switches.json``."""
    import torch

    from ..run_api import run_entry

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    run, config, bindings = northstar.arm_phases(workdir, ARM, SEED, EPOCHS, 50, "cuda")["train"]
    run_entry("train", run, config, bindings)
    with open(os.path.join(run, "switches.json"), "w") as f:
        json.dump({"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                   "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn.deterministic": torch.backends.cudnn.deterministic,
                   "cudnn.benchmark": torch.backends.cudnn.benchmark,
                   "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS"),
                   "torch.get_num_threads": torch.get_num_threads()}, f)


def _start(root, name, env):
    workdir = os.path.join(root, name)
    os.makedirs(workdir, exist_ok=True)
    if not os.path.lexists(os.path.join(workdir, "data")):
        os.symlink(os.path.join(root, "data"), os.path.join(workdir, "data"))
    log = open(os.path.join(workdir, "train.log"), "w")
    proc = subprocess.Popen([sys.executable, "-m", MODULE, root, "--train", workdir],
                            cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=env)
    return workdir, proc, log


def _finish(started, t0):
    out = {}
    for name, (workdir, proc, log) in started.items():
        rc = proc.wait()
        log.close()
        out[name] = {"workdir": workdir, "rc": rc, "wall_s": time.time() - t0}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--train", metavar="RUN_WORKDIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.train:
        train_one(args.train)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("shard_check: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.workdir)
    northstar.make_corpus(root)
    runs = {}
    for name in ("alone0", "alone1"):
        t0 = time.time()
        runs.update(_finish({name: _start(root, name, dict(os.environ))}, t0))
    side_env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.time()
    runs.update(_finish({f"side{k}": _start(root, f"side{k}", side_env)
                         for k in range(SIDE_BY_SIDE)}, t0))

    report = {"arm": ARM, "seed": SEED, "epochs": EPOCHS, "runs": {}}
    ref = None
    for name, r in runs.items():
        run = os.path.join(r["workdir"], f"{ARM}_s{SEED}")
        entry = {"rc": r["rc"], "wall_s": r["wall_s"]}
        if r["rc"] == 0:
            hist = read_history(os.path.join(run, "history.csv"))
            ref = ref or hist
            entry["against_alone0"] = compare_histories(ref, hist)
            entry["final"] = {c: hist[c][-1] for c in ("loss", "acc", "val_acc", "test_acc")}
            with open(os.path.join(run, "switches.json")) as f:
                entry["switches"] = json.load(f)
        report["runs"][name] = entry
    print(json.dumps(report))
    return 0 if all(r["rc"] == 0 for r in runs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
