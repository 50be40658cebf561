"""North-star run-level experiment driver (BASELINE.json accuracy targets) on
the port: ``tools/run_northstar.py`` with the port's entries.

Runs the paper's headline comparison — guided (configs/training_guided.gin)
vs random-curation (configs/training_random.gin) — to convergence on the
modality-imbalanced dataset (:mod:`.imbalanced_modelnet`), two seeds each,
through the port's CLI, then the full two-pass conditional-utilization-rate
pipeline (configs/recording.gin → configs/eval.gin) on every trained run
(reference workflow: README.md:12-23).

Produces <workdir>/northstar_summary.json with, per run: final/best
accuracies, per-modality accuracies, steps-to-90%-top-1, and the
cross-modal-flow-off (conditional utilization) per-modality accuracies;
``python -m greedy_multimodal_learning_tpu_torch.experiments.analyze``
reads it (``--reference`` a JAX summary to compare the arms against).

Usage:  python -m greedy_multimodal_learning_tpu_torch.experiments.northstar WORKDIR
            [--epochs 300] [--seeds 777 1234] [--arms guided random] [--device cuda]

``--device`` is the entries' ``train.device`` / ``eval_.device`` (the JAX
driver's backend comes from ``JAX_PLATFORMS``).  :func:`run_suite` is the
same driver for callers that add bindings (``extra_bindings``) and make a
corpus of their own in ``WORKDIR/data`` first.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from .common import argmax_first, mean_skipna, read_history, run_phase, sh

SUMMARY = "northstar_summary.json"
ARM_CONFIGS = {
    "guided": "configs/training_guided.gin",
    "random": "configs/training_random.gin",
    "weakest": "configs/training_weakest.gin",
}


def train_complete(run_dir, n_epochs):
    """history.csv exists at every epoch, so its existence alone does NOT
    mean training finished — an interrupted run would silently enter the
    statistics.  Complete = reached the epoch budget (n_epochs-1 executed,
    quirk #3) or CompletedStopping fired (>= 5 epochs at train acc 100,
    the shipped configs' patience)."""
    hist = os.path.join(run_dir, "history.csv")
    if not os.path.exists(hist):
        return False
    df = read_history(hist)
    if not df or len(df["epoch"]) == 0:
        return False
    if int(df["epoch"][-1]) >= n_epochs - 1:
        return True
    return sum(1 for a in df["acc"] if a == 100.0) >= 5


def summarize_run(run_dir, steps_per_epoch):
    df = read_history(os.path.join(run_dir, "history.csv"))
    best_i = argmax_first(df["val_acc"])
    over90 = [i for i, a in enumerate(df["test_acc"]) if a >= 90.0]
    out = {
        "epochs_run": int(df["epoch"][-1]),
        "best_val_epoch": int(df["epoch"][best_i]),
        "best_val_acc": float(df["val_acc"][best_i]),
        # checkpoint-selected metrics (reference selection: best val_acc)
        "test_acc": float(df["test_acc"][best_i]),
        "test_acc_modal_0": float(df["test_acc_modal_0"][best_i]),
        "test_acc_modal_1": float(df["test_acc_modal_1"][best_i]),
        "final_train_acc": float(df["acc"][-1]),
        "final_train_acc_modal_0": float(df["acc_modal_0"][-1]),
        "final_train_acc_modal_1": float(df["acc_modal_1"][-1]),
        "steps_to_90_top1": int(df["epoch"][over90[0]]) * steps_per_epoch if over90 else None,
        "mean_train_samples_per_sec": float(mean_skipna(df["train_samples_per_sec"][1:])),
    }
    return out


def read_mmtm_off(run_dir):
    path = os.path.join(run_dir, "mmtm_off_eval", "eval_history_batch", "history.csv")
    df = read_history(path)
    return {
        "flowoff_test_acc": float(df["test_acc"][-1]),
        "flowoff_test_acc_modal_0": float(df["test_acc_modal_0"][-1]),
        "flowoff_test_acc_modal_1": float(df["test_acc_modal_1"][-1]),
    }


def steps_per_epoch(data):
    """Steps an epoch from the actual dataset: the shipped training configs
    use batch 8 and a 20% val split (configs/training*.gin); reference split:
    val = floor(0.2n), train = n - floor(0.2n)
    (data/modelnet.py::reference_val_split) — not floor(0.8n)."""
    with open(os.path.join(data, "metadata.json")) as f:
        n_train_total = len(json.load(f)["train"])
    n_train_split = n_train_total - int(math.floor(0.2 * n_train_total))
    return -(-n_train_split // 8)


def arm_phases(workdir, kind, seed, epochs, checkpoint_every, device=None, extra_bindings=""):
    """The three phases of one run: {"train" | "record" | "flow_off": (save
    path, config, bindings)}, the JAX driver's, with ``train.device`` /
    ``eval_.device`` bound to ``device`` unless it is None, then
    ``extra_bindings``."""
    data = os.path.join(workdir, "data")
    run = os.path.join(workdir, f"{kind}_s{seed}")
    ckpt = os.path.join(run, "model_best_val.pt")
    train_dev = f"#train.device='{device}'" if device else ""
    eval_dev = f"#eval_.device='{device}'" if device else ""
    off_dir = os.path.join(run, "mmtm_off_eval")
    return {
        "train": (run, ARM_CONFIGS[kind], (
            f"get_mvdcndata.root_dir='{data}'"
            f"#train.seed={seed}"
            f"#training_loop.n_epochs={epochs}"
            f"#training_loop.checkpoint_every={checkpoint_every}"
        ) + train_dev + extra_bindings),
        "record": (run, "configs/recording.gin",
                   f"eval_.pretrained_weights_path='{ckpt}'#get_mvdcndata.root_dir='{data}'" + eval_dev
                   + extra_bindings),
        "flow_off": (off_dir, "configs/eval.gin", (
            f"MMTM_MVCNN.mmtm_rescale_eval_file_path='{os.path.join(run, 'eval_history_batch')}'"
            f"#MMTM_MVCNN.mmtm_rescale_training_file_path='{run}'"
            f"#eval_.pretrained_weights_path='{ckpt}'"
            f"#get_mvdcndata.root_dir='{data}'"
        ) + eval_dev + extra_bindings),
    }


def make_corpus(workdir):
    """The suite's corpus under ``workdir/data``, made unless it holds one;
    returns its path."""
    data = os.path.join(workdir, "data")
    os.makedirs(workdir, exist_ok=True)
    if not os.path.exists(os.path.join(data, "metadata.json")):
        rc = sh([sys.executable, "-m", "greedy_multimodal_learning_tpu_torch.experiments.imbalanced_modelnet", data],
                os.path.join(workdir, "datagen.log"))
        if rc != 0:
            raise RuntimeError(f"imbalanced_modelnet: rc {rc} (see {workdir}/datagen.log)")
    return data


def run_suite(workdir, epochs=300, seeds=(777, 1234), arms=("guided", "random"), checkpoint_every=50,
              in_process=False, device="cuda", extra_bindings=""):
    """The driver: makes the corpus unless ``workdir/data`` holds one, then
    each arm and seed: train (resuming an interrupted run), record, flow
    off, summarize.  Returns the summary."""
    # Subprocesses run with cwd=REPO: a relative workdir would split
    # artifacts between two trees (driver resolves against invoking cwd).
    workdir = os.path.abspath(workdir)
    data = make_corpus(workdir)

    summary_path = os.path.join(workdir, SUMMARY)
    summary = {}
    if os.path.exists(summary_path):  # merge across driver invocations
        with open(summary_path) as f:
            summary = json.load(f)
    for kind in arms:
        for seed in seeds:
            name = f"{kind}_s{seed}"
            log = os.path.join(workdir, f"{name}.log")
            phases = arm_phases(workdir, kind, seed, epochs, checkpoint_every, device, extra_bindings)
            run, config, bindings = phases["train"]
            if not train_complete(run, epochs):
                if os.path.exists(os.path.join(run, "history.csv")):
                    # interrupted earlier invocation: finish it via the
                    # framework's exact-resume path instead of skipping
                    bindings += "#training_loop.resume=True"
                rc = run_phase("train", run, config, bindings, log, in_process)
                if rc != 0:
                    summary[name] = {"error": f"train rc={rc}"}
                    continue

            if not os.path.exists(os.path.join(run, "eval_history_batch", "history.pickle")):
                run_phase("eval", *phases["record"], log, in_process)

            off_dir = phases["flow_off"][0]
            if not os.path.exists(os.path.join(off_dir, "eval_history_batch", "history.csv")):
                run_phase("eval", *phases["flow_off"], log, in_process)

            try:
                summary[name] = summarize_run(run, steps_per_epoch(data))
                summary[name].update(read_mmtm_off(run))
            except Exception as e:  # summarize failures shouldn't kill the suite
                summary[name] = {"error": repr(e)}
            with open(summary_path, "w") as f:
                json.dump(summary, f, indent=2)
            print(json.dumps({name: summary[name]}, indent=2), flush=True)

    print("DONE", flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--seeds", type=int, nargs="+", default=[777, 1234])
    ap.add_argument(
        "--arms",
        nargs="+",
        default=["guided", "random"],
        choices=["guided", "random", "weakest"],
        help="controller arms to run (weakest = Bias_Mitigation_Weakest, "
        "the framework extension — configs/training_weakest.gin)",
    )
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument(
        "--in-process",
        action="store_true",
        help="drive phases via run_api.run_entry in this process instead of "
        "one subprocess per phase; see experiments/common.py",
    )
    ap.add_argument("--device", default="cuda", help="the entries' train.device / eval_.device")
    args = ap.parse_args(argv)
    run_suite(args.workdir, epochs=args.epochs, seeds=args.seeds, arms=args.arms,
              checkpoint_every=args.checkpoint_every, in_process=args.in_process, device=args.device)


if __name__ == "__main__":
    main()
