"""Two checkouts' gating kernels timed in one run on one GPU.

    python3 kernel_ab.py OLD NEW [--profile-training] [--train-entry]

OLD and NEW are roots of checkouts of this repository (for example the
parent commit unpacked with ``git archive`` into ``_work_parent/``, and
``.``).  In turns OLD, NEW, NEW, OLD, each in its own process with its
working directory at that root, it builds that checkout's kernels and runs
its ``chip_smoke.py`` kernel phases (2: the forward against its plain
version with times; 4: the backward) with one timing function for both, so
the two designs meet the same card, power limit, neighbours and clock.
With ``--profile-training`` it then runs each checkout's
``profile_training`` (step time, device busy share and the in-step gating
ms, warm L2), also in turns OLD, NEW, NEW, OLD.  With ``--train-entry`` it
then runs each checkout's ``chip_smoke.py`` phase 5 (the guided ``train``
entry on its synthetic 224² split, f32 and bf16, kernels: samples/s per
epoch), in the same turns.  Prints
one JSON object per run and a summary, and writes everything to
``chiprun_out/kernel_ab.json``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# Runs in the checkout under test: only its own chip_smoke.py and package.
PHASES = r"""
import json, sys, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs

def time_ms(fn, args, iters=20, warmup=3):
    # the same timing for both checkouts: L2 flushed, then a device-side
    # sleep so the events time the device, not the host's enqueue
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))

cs.time_ms = time_ms
cs.kernel_build.build(["mmtm_gating", "mmtm_gating_bwd"])
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
out = {"smi": cs.smi_line()}
for key, phase in (("fwd", cs.kernel_phase), ("bwd", cs.backward_kernel_phase)):
    out[key] = {str(dt)[6:]: rep for dt, rep in phase().items()}
print("KERNEL_AB " + json.dumps(out))
"""

# Runs in the checkout under test: its chip_smoke.py phase 5.
TRAIN = r"""
import json, shutil, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
cs.kernel_build.build(["mmtm_gating", "mmtm_gating_bwd"])
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
try:
    out = cs.training_phase()
finally:
    shutil.rmtree(cs.TRAIN_DATA, ignore_errors=True)
    shutil.rmtree(cs.TRAIN_RUNS, ignore_errors=True)
print("TRAIN_AB " + json.dumps({k: v["train_samples_per_s"] for k, v in out.items()}))
"""

TIMED = ("ms", "bound_ms", "plain_ms", "eager_ms", "eager_autograd_ms")


def run_phases(root):
    r = subprocess.run([sys.executable, "-c", PHASES], cwd=root, capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"kernel phases failed in {root}:\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    line = [l for l in r.stdout.splitlines() if l.startswith("KERNEL_AB ")][-1]
    return json.loads(line[len("KERNEL_AB "):])


def run_train(root):
    r = subprocess.run([sys.executable, "-c", TRAIN], cwd=root, capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"phase 5 failed in {root}:\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    line = [l for l in r.stdout.splitlines() if l.startswith("TRAIN_AB ")][-1]
    return json.loads(line[len("TRAIN_AB "):])


def run_profile(root):
    cmd = [sys.executable, "-m", "greedy_multimodal_learning_tpu_torch.profile_training"]
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"profile_training failed in {root}:\n{r.stderr[-4000:]}")
    return [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")]


def summary(runs):
    """Per direction, dtype and site: each run's kernel ms, in run order, with
    the bound and yardsticks of the first run of each tree."""
    out = {}
    for tag, res in runs:
        for direction in ("fwd", "bwd"):
            for dtype, rep in res[direction].items():
                for site, t in rep["sites"].items():
                    row = out.setdefault(f"{direction} {dtype} {site}", {})
                    row.setdefault(f"{tag}_ms", []).append(t["ms"])
                    for k in TIMED[1:]:
                        if k in t:
                            row.setdefault(f"{tag}_{k}", t[k])
                row = out.setdefault(f"{direction} {dtype} total", {})
                row.setdefault(f"{tag}_ms", []).append(rep["ms"])
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("old")
    parser.add_argument("new")
    parser.add_argument("--profile-training", action="store_true")
    parser.add_argument("--train-entry", action="store_true")
    args = parser.parse_args()
    trees = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    runs = []
    for tag in ("old", "new", "new", "old"):
        res = run_phases(trees[tag])
        totals = {d: {dt: rep["ms"] for dt, rep in res[d].items()} for d in ("fwd", "bwd")}
        print(json.dumps({"run": tag, "root": trees[tag], "ms_per_call_3_sites": totals}), flush=True)
        runs.append((tag, res))
    result = {"smi": runs[0][1]["smi"], "summary": summary(runs), "runs": [{"tag": t, **r} for t, r in runs]}
    if args.profile_training:
        result["profile_training"] = {"old": [], "new": []}
        for tag in ("old", "new", "new", "old"):
            rows = run_profile(trees[tag])
            result["profile_training"][tag].append(rows)
            for row in rows:
                brief = {k: v for k, v in row.items() if k != "kernels"}
                print(json.dumps({"profile_training": tag, **brief}), flush=True)
    if args.train_entry:
        result["train_entry"] = []
        for tag in ("old", "new", "new", "old"):
            rates = run_train(trees[tag])
            result["train_entry"].append({"run": tag, "train_samples_per_s": rates})
            print(json.dumps(result["train_entry"][-1]), flush=True)
    print(json.dumps({"summary": result["summary"]}), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
