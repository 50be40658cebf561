"""Run a north-star suite in shards side by side on one card, and merge the
shards' results into one summary.

A driver (:mod:`.northstar`, :mod:`.northstar3d`) runs its seeds one after
another in one work directory, and its B=8 steps leave the card mostly
idle.  A shard is a work directory of its own with a driver process of its
own: ``run`` starts ``--shards`` of them, which take the (arm, seed) runs
one at a time from a shared queue, each through the driver's CLI at its
defaults on the card.  The corpus is made once, by the driver's own
``make_corpus``, under ``ROOT/data``, and every shard's ``data`` links to it
(the generator writes the same bytes from the same arguments, so a shard's
own would be identical).  ``merge`` writes the
union of the shards' summaries and each run's ``history.csv`` and flow-off
``history.csv`` into one directory, beside each shard's driver log.

Usage:
    python -m greedy_multimodal_learning_tpu_torch.experiments.shards run {2d,3d} ROOT
        --shards N (--seeds 5 7 ... | --seeds-of SUMMARY) [--arms guided random] [--skip SUMMARY]
    python -m greedy_multimodal_learning_tpu_torch.experiments.shards merge {2d,3d} OUT ROOT/shard0 ...

``run`` writes ``ROOT/shards.log`` (each run's start and end, seconds from
the start) and ``ROOT/device.txt`` (the card's ``nvidia-smi`` name and power
limit, and the TF32 switches of a fresh process, read in ``run``'s own
process: the drivers' train processes bind no ``train.matmul_precision``,
which leaves these defaults, and are not read themselves).  A shard's driver log is
``ROOT/shard<k>/driver.log``.  An interrupted ``run`` resumes where the
drivers left off.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import shutil
import subprocess
import sys
import threading
import time

from . import northstar, northstar3d
from .common import REPO

FAMILIES = {"2d": northstar, "3d": northstar3d}


def precision_line():
    """The TF32 switches of a fresh process, which a driver's train process
    keeps: it binds no ``matmul_precision``."""
    import torch

    return (f"train.matmul_precision=None (a fresh process's defaults, read outside the train processes): "
            f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def smi_line():
    """``nvidia-smi``'s name and power limit of the first card, or why not."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "nvidia-smi: no card"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e!r}"


def run_shards(family, root, runs, shards=1):
    """The (arm, seed) ``runs`` of ``family``, in that order, over ``shards``
    driver processes on the card, each with ``OMP_NUM_THREADS`` at the CPU
    cores over ``shards``; returns {run name: driver rc}."""
    driver = FAMILIES[family]
    root = os.path.abspath(root)
    data = driver.make_corpus(root)
    with open(os.path.join(root, "device.txt"), "w") as f:
        f.write(smi_line() + "\n" + precision_line() + "\n")

    env = dict(os.environ)
    threads = max(1, (os.cpu_count() or 1) // shards)
    env["OMP_NUM_THREADS"] = str(threads)
    jobs = queue.Queue()
    for arm, seed in runs:
        jobs.put((arm, seed))
    rcs, lock, t0 = {}, threading.Lock(), time.time()
    shards_log = open(os.path.join(root, "shards.log"), "a")

    def note(text):
        with lock:
            shards_log.write(f"{time.time() - t0:.1f}s {text}\n")
            shards_log.flush()

    def worker(k):
        workdir = os.path.join(root, f"shard{k}")
        os.makedirs(workdir, exist_ok=True)
        if not os.path.lexists(os.path.join(workdir, "data")):
            os.symlink(data, os.path.join(workdir, "data"))
        while True:
            try:
                arm, seed = jobs.get_nowait()
            except queue.Empty:
                return
            name = f"{arm}_s{seed}"
            note(f"shard{k} start {name}")
            with open(os.path.join(workdir, "driver.log"), "a") as log:
                rc = subprocess.run([sys.executable, "-m", driver.__name__, workdir, "--arms", arm,
                                     "--seeds", str(seed), "--device", "cuda"],
                                    cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=env).returncode
            rcs[name] = rc
            note(f"shard{k} end {name} rc={rc}")

    pool = [threading.Thread(target=worker, args=(k,)) for k in range(shards)]
    note(f"{family}: {shards} shards, OMP_NUM_THREADS={threads}, {jobs.qsize()} runs")
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    note(f"{family}: done, wall {time.time() - t0:.1f}s")
    shards_log.close()
    return rcs


def _add_lines(src, dst):
    """Append to ``dst`` the lines of ``src`` (when it exists) that ``dst``
    lacks."""
    if not os.path.exists(src):
        return
    have = open(dst).read().splitlines() if os.path.exists(dst) else []
    with open(src) as f, open(dst, "a") as out:
        for line in f.read().splitlines():
            if line not in have:
                out.write(line + "\n")
                have.append(line)


def summary_runs(summary_path):
    """The (arm, seed) runs that the summary at ``summary_path`` holds
    without an error."""
    with open(summary_path) as f:
        names = [name for name, entry in json.load(f).items() if "error" not in entry]
    return {(name.rsplit("_s", 1)[0], int(name.rsplit("_s", 1)[1])) for name in names}


def plan_runs(arms, seeds=None, seeds_of=None, skip=None):
    """Each arm's runs, arm by arm, seeds ascending: at ``seeds``, or at the
    arm's seeds in the summary ``seeds_of``; those that the summary ``skip``
    holds left out."""
    held = summary_runs(seeds_of) if seeds_of else set()
    done = summary_runs(skip) if skip else set()
    runs = []
    for arm in arms:
        arm_seeds = seeds if seeds else [s for a, s in held if a == arm]
        runs += [(arm, s) for s in sorted(arm_seeds) if (arm, s) not in done]
    return runs


def merge_shards(family, out, shard_dirs):
    """The union of the shards' summaries and of ``out``'s own, written to
    ``out``; each run's history and flow-off history, each shard's driver
    log (``driver_<root>_<shard>.log``) and its root's ``shards.log``
    (``shards_<root>.log``) copied there, and the lines of the root's
    ``device.txt`` that ``out/device.txt`` lacks added to it.  A run that
    two sources hold with different entries raises.  Returns the summary."""
    summary_file = FAMILIES[family].SUMMARY
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, summary_file)
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    for shard in shard_dirs:
        with open(os.path.join(shard, summary_file)) as f:
            entries = json.load(f)
        for name, entry in entries.items():
            if name in merged and merged[name] != entry:
                raise ValueError(f"{name}: {shard} and an earlier source hold different entries")
            merged[name] = entry
            run = os.path.join(shard, name)
            shutil.copyfile(os.path.join(run, "history.csv"), os.path.join(out, f"{name}_history.csv"))
            shutil.copyfile(os.path.join(run, "mmtm_off_eval", "eval_history_batch", "history.csv"),
                            os.path.join(out, f"{name}_flowoff_history.csv"))
        root = os.path.dirname(os.path.abspath(shard))
        tag = f"{os.path.basename(root)}_{os.path.basename(os.path.abspath(shard))}"
        shutil.copyfile(os.path.join(shard, "driver.log"), os.path.join(out, f"driver_{tag}.log"))
        if os.path.exists(os.path.join(root, "shards.log")):
            shutil.copyfile(os.path.join(root, "shards.log"), os.path.join(out, f"shards_{os.path.basename(root)}.log"))
        _add_lines(os.path.join(root, "device.txt"), os.path.join(out, "device.txt"))
    merged = dict(sorted(merged.items()))
    with open(path, "w") as f:
        json.dump(merged, f, indent=2)
    return merged


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command", required=True)
    r = sub.add_parser("run", help="run the (arm, seed) runs over shards")
    r.add_argument("family", choices=sorted(FAMILIES))
    r.add_argument("root")
    seeds = r.add_mutually_exclusive_group(required=True)
    seeds.add_argument("--seeds", type=int, nargs="+")
    seeds.add_argument("--seeds-of", metavar="SUMMARY", help="each arm at the seeds this summary holds it at")
    r.add_argument("--arms", nargs="+", default=["guided", "random"])
    r.add_argument("--shards", type=int, default=1)
    r.add_argument("--skip", metavar="SUMMARY", help="leave out the runs this summary holds without an error")
    m = sub.add_parser("merge", help="merge the shards' summaries and histories into OUT")
    m.add_argument("family", choices=sorted(FAMILIES))
    m.add_argument("out")
    m.add_argument("shard_dirs", nargs="+")
    args = ap.parse_args(argv)
    if args.command == "run":
        runs = plan_runs(args.arms, args.seeds, args.seeds_of, args.skip)
        rcs = run_shards(args.family, args.root, runs, args.shards)
        failed = {k: v for k, v in rcs.items() if v != 0}
        print(json.dumps({"runs": len(rcs), "failed": failed}))
        return 1 if failed else 0
    merged = merge_shards(args.family, args.out, args.shard_dirs)
    print(json.dumps({"runs": len(merged)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
