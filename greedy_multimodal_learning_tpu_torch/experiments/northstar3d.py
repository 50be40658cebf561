"""3-modality (3D-CNN family) run-level experiment driver on the port:
``tools/run_northstar3d.py`` with the port's entries.

The N-modality analogue of :mod:`.northstar` (BASELINE config 4): guided
(configs/training_3dcnn_guided.gin) vs random-curation
(configs/training_3dcnn_random.gin) on the graded-imbalance synthetic clip
dataset (:mod:`.imbalanced_nvgesture`), then the two-pass
conditional-utilization pipeline (configs/recording_3dcnn.gin →
configs/eval_3dcnn.gin) on every trained run.

Produces <workdir>/northstar3d_summary.json with, per run: epochs, test
top-1, per-modality accuracies, and the cross-modal-flow-off per-modality
accuracies for all three modalities; ``python -m
greedy_multimodal_learning_tpu_torch.experiments.analyze`` reads it.

Usage:  python -m greedy_multimodal_learning_tpu_torch.experiments.northstar3d WORKDIR
            [--seeds 7 42] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .common import argmax_first, read_history, run_phase, sh

SUMMARY = "northstar3d_summary.json"
# Small-but-real scale: 10 classes, 400/150 clips, 8 frames @32^2,
# width 0.5 — minutes per arm on one chip, still imbalanced enough that
# greedy learning visibly favors modality 0.
DATA_ARGS = ["--n-train", "400", "--n-test", "150", "--size", "32", "--frames", "8", "--nclasses", "10"]
WIDTH = 0.5
EPOCHS_DEFAULT = 60
ARM_CONFIGS = {
    "guided": "configs/training_3dcnn_guided.gin",
    "random": "configs/training_3dcnn_random.gin",
    "weakest": "configs/training_3dcnn_weakest.gin",
    "weakest80": "configs/training_3dcnn_weakest.gin",
    "adaptive": "configs/training_3dcnn_adaptive.gin",
}
ARM_BINDINGS = {
    "weakest80": "#Bias_Mitigation_Weakest.curation_windowsize=8",
}


def train_complete(run_dir, n_epochs):
    hist = os.path.join(run_dir, "history.csv")
    if not os.path.exists(hist):
        return False
    df = read_history(hist)
    if not df or len(df["epoch"]) == 0:
        return False
    if int(df["epoch"][-1]) >= n_epochs - 1:
        return True
    return sum(1 for a in df["acc"] if a == 100.0) >= 5


def summarize_run(run_dir):
    df = read_history(os.path.join(run_dir, "history.csv"))
    best = argmax_first(df["val_acc"])
    out = {
        "epochs_run": int(df["epoch"][-1]),
        "best_val_epoch": int(df["epoch"][best]),
        "best_val_acc": float(df["val_acc"][best]),
        "test_acc": float(df["test_acc"][best]),
        "final_train_acc": float(df["acc"][-1]),
    }
    for m in range(3):
        out[f"test_acc_modal_{m}"] = float(df[f"test_acc_modal_{m}"][best])
        out[f"final_train_acc_modal_{m}"] = float(df[f"acc_modal_{m}"][-1])
    # Which modality was weakest on val at each epoch end (the target the
    # weakest controller designates; mechanism telemetry for every arm).
    rows = list(zip(*(df[f"val_acc_modal_{m}"] for m in range(3))))
    am = [min(range(3), key=row.__getitem__) for row in rows]
    out["val_weakest_counts"] = [sum(1 for a in am if a == m) for m in range(3)]
    return out


def read_mmtm_off(run_dir):
    df = read_history(os.path.join(run_dir, "mmtm_off_eval", "eval_history_batch", "history.csv"))
    out = {"flowoff_test_acc": float(df["test_acc"][-1])}
    for m in range(3):
        out[f"flowoff_test_acc_modal_{m}"] = float(df[f"test_acc_modal_{m}"][-1])
    return out


def arm_phases(workdir, kind, seed, epochs, checkpoint_every, device=None):
    """The three phases of one run: {"train" | "record" | "flow_off": (save
    path, config, bindings)}, the JAX driver's, with ``train.device`` /
    ``eval_.device`` bound to ``device`` unless it is None."""
    data = os.path.join(workdir, "data")
    run = os.path.join(workdir, f"{kind}_s{seed}")
    ckpt = os.path.join(run, "model_best_val.pt")
    common = (
        f"get_nvgesturedata.root_dir='{data}'"
        f"#MMTM_3DCNN.nclasses=10"
        f"#MMTM_3DCNN.width_multiplier={WIDTH}"
    )
    train_dev = f"#train.device='{device}'" if device else ""
    eval_dev = f"#eval_.device='{device}'" if device else ""
    return {
        "train": (run, ARM_CONFIGS[kind], (
            common
            + ARM_BINDINGS.get(kind, "")
            + f"#train.seed={seed}"
            + f"#training_loop.n_epochs={epochs}"
            + f"#training_loop.checkpoint_every={checkpoint_every}"
        ) + train_dev),
        "record": (run, "configs/recording_3dcnn.gin", common + f"#eval_.pretrained_weights_path='{ckpt}'" + eval_dev),
        "flow_off": (os.path.join(run, "mmtm_off_eval"), "configs/eval_3dcnn.gin", (
            common
            + f"#MMTM_3DCNN.mmtm_rescale_eval_file_path='{os.path.join(run, 'eval_history_batch')}'"
            + f"#MMTM_3DCNN.mmtm_rescale_training_file_path='{run}'"
            + f"#eval_.pretrained_weights_path='{ckpt}'"
        ) + eval_dev),
    }


def make_corpus(workdir):
    """The suite's corpus under ``workdir/data``, made unless it holds one;
    returns its path."""
    data = os.path.join(workdir, "data")
    os.makedirs(workdir, exist_ok=True)
    if not os.path.exists(os.path.join(data, "metadata.json")):
        rc = sh([sys.executable, "-m", "greedy_multimodal_learning_tpu_torch.experiments.imbalanced_nvgesture", data]
                + DATA_ARGS, os.path.join(workdir, "datagen.log"))
        if rc != 0:
            raise RuntimeError(f"imbalanced_nvgesture: rc {rc} (see {workdir}/datagen.log)")
    return data


def run_suite(workdir, epochs=EPOCHS_DEFAULT, seeds=(7, 42), arms=("guided", "random"), checkpoint_every=50,
              in_process=False, device="cuda"):
    """The driver: makes the corpus unless ``workdir/data`` holds one, then
    each arm and seed: train (resuming an interrupted run), record, flow
    off, summarize.  Returns the summary."""
    workdir = os.path.abspath(workdir)
    make_corpus(workdir)

    summary_path = os.path.join(workdir, SUMMARY)
    summary = {}
    if os.path.exists(summary_path):  # merge across driver invocations
        with open(summary_path) as f:
            summary = json.load(f)

    for kind in arms:
        for seed in seeds:
            name = f"{kind}_s{seed}"
            log = os.path.join(workdir, f"{name}.log")
            phases = arm_phases(workdir, kind, seed, epochs, checkpoint_every, device)
            run, config, bindings = phases["train"]
            if not train_complete(run, epochs):
                if os.path.exists(os.path.join(run, "history.csv")):
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
                summary[name] = summarize_run(run)
                summary[name].update(read_mmtm_off(run))
            except Exception as e:
                summary[name] = {"error": repr(e)}
            with open(summary_path, "w") as f:
                json.dump(summary, f, indent=2)
            print(json.dumps({name: summary[name]}, indent=2), flush=True)

    print("DONE", flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--epochs", type=int, default=EPOCHS_DEFAULT)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 42])
    ap.add_argument(
        "--arms",
        nargs="+",
        default=["guided", "random"],
        choices=["guided", "random", "weakest", "weakest80", "adaptive"],
        help="which controller arms to run (weakest = Bias_Mitigation_Weakest, "
        "the N-modality extension — see configs/training_3dcnn_weakest.gin; "
        "weakest80 = the same controller at an 8-of-10-step duty cycle, the "
        "curation-intensity follow-up RESULTS.md's 18-seed analysis calls for; "
        "adaptive = Bias_Mitigation_AdaptiveWeakest, weakest targeting gated "
        "on the val-accuracy gap with guided's window semantics — "
        "configs/training_3dcnn_adaptive.gin, RESULTS.md Finding 4)",
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
