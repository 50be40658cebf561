"""Data parallelism through the port's entries on the CPU: ``train`` and the
recording ``eval_`` with ``data_parallel=True`` at two spawned gloo ranks
(one thread each, a 60 s group timeout, every run with a deadline) against
the same entries in one process, both model families (the counterpart of
``tests/test_integration_dp.py``):

* ``train`` at two ranks writes the one-process run's files and
  ``history.csv`` columns, the same epochs, and metrics within
  ``HISTORY_TOL`` in the first epoch and ``LATER_TOL`` after it: a gradient
  summed over two ranks rounds apart from the one-process sum (~1e-6), and
  each step of this tiny network multiplies such a difference (the losses
  of the second epoch differ by ~1e-3 at lr 1e-3);
* only rank 0 writes: the other rank opens no file for writing, saves no
  tensor, removes and renames nothing;
* ``resume`` at two ranks continues to the straight two-rank run exactly;
* the recording ``eval_`` at two ranks writes ``history.pickle`` with every
  index once, in the one-process order, and its squeeze maps within
  ``MAPS_TOL`` of the one-process pass (convolutions of 4 rows against 8);
* with no process group, ``data_parallel=True`` runs over a one-rank group
  of its own and gives the one-process run's history.
"""

import builtins
import csv
import datetime
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.data.nvgesture import make_synthetic_nvgesture
from greedy_multimodal_learning_tpu_torch.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch.entries import eval_, train
from greedy_multimodal_learning_tpu_torch.parallel.launch import run_ranks

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = {name: os.path.join(REPO, "configs", f"{name}.gin")
           for name in ("training_guided", "recording", "training_3dcnn_guided", "recording_3dcnn")}
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
RUN_TIMEOUT = 200.0  # seconds for every rank of the spawned runs
IMG, NC, BATCH = 32, 4, 8
HISTORY_TOL = (1e-4, 1e-5)  # (rtol, atol) of the first epoch's metrics, two ranks against one process
LATER_TOL = (1e-2, 1e-5)  # of the later epochs' metrics
MAPS_TOL = (1e-5, 1e-5)  # the recorded squeeze maps: the kernel's sq tolerance
TIME_COLUMNS = ("time", "epoch_begin_time", "train_samples_per_sec")


def _bindings_2d(root):
    return [
        f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", f"MMTM_MVCNN.nclasses={NC}",
        f"train.batch_size={BATCH}", "train.lr=0.001", "train.device='cpu'", "training_loop.n_epochs=3",
    ]


def _bindings_3d(root):
    return [
        f"get_nvgesturedata.root_dir='{root}'", "MMTM_3DCNN.width_multiplier=0.25", f"MMTM_3DCNN.nclasses={NC}",
        f"train.batch_size={BATCH}", "train.lr=0.001", "train.device='cpu'", "training_loop.n_epochs=2",
    ]


def _run(entry, config, bindings, save_path):
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings([CONFIGS[config]], "\n".join(bindings))
    try:
        return entry(save_path)
    finally:
        port_cfg.clear_config()


def _runs(base, roots, data_parallel):
    """The entry runs of one process or of one rank, under ``base``."""
    dp = [f"training_loop.data_parallel={data_parallel}"]
    b2, b3 = _bindings_2d(roots["2d"]), _bindings_3d(roots["3d"])
    out = {}
    trainer = _run(train, "training_guided", b2 + dp, os.path.join(base, "train"))
    out["steps"] = trainer.step
    if data_parallel:  # one epoch, then resumed to the straight run's two
        _run(train, "training_guided", b2 + dp + ["training_loop.n_epochs=2"], os.path.join(base, "resumed"))
        _run(train, "training_guided", b2 + dp + ["training_loop.resume=True"], os.path.join(base, "resumed"))
    _run(train, "training_3dcnn_guided", b3 + dp, os.path.join(base, "train3d"))
    # the recording pass over the whole train file (20 samples, the third
    # batch of 8 half padding: the second rank's rows of it all padding)
    # on the one-process run's checkpoint
    _run(eval_, "recording", b2 + [
        "get_mvdcndata.valid_size=0", "eval_.target_data_split='train'", "eval_.batch_size=8", "eval_.device='cpu'",
        f"evalution_loop.data_parallel={data_parallel}",
        f"eval_.pretrained_weights_path='{roots['ckpt']}'"], os.path.join(base, "record"))
    return out


def _rank_runs(rank, base, roots):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", timeout=GROUP_TIMEOUT)
    writes = []  # the rank's file writes: opens for writing, tensor saves, removals and renames

    def watch(fn, kind):
        def wrapper(path, *args, **kwargs):
            mode = args[0] if args else kwargs.get("mode", "r")
            if kind != "open" or any(c in mode for c in "wax+"):
                writes.append((kind, os.path.basename(str(path)), str(path)))
            return fn(path, *args, **kwargs)
        return wrapper

    builtins.open = watch(builtins.open, "open")
    os.remove, os.replace, torch.save = watch(os.remove, "remove"), watch(os.replace, "replace"), watch(
        torch.save, "torch.save")
    try:
        out = _runs(base, roots, True)
    finally:
        dist.destroy_process_group()
    out["writes"] = sorted({w[:2] for w in writes if w[2].startswith(base)})
    return out


def _history(path):
    with open(os.path.join(path, "history.csv")) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _summary(base):
    """What the tests read of the runs under ``base``: each training run's
    history, files and last checkpoint, and the recording's pickle."""
    out = {}
    for run in ("train", "resumed", "train3d"):
        path = os.path.join(base, run)
        if os.path.isdir(path):
            out[run] = {
                "history": _history(path),
                "files": sorted(os.path.relpath(os.path.join(d, f), path) for d, _, files in os.walk(path)
                                for f in files),
                "last": torch.load(os.path.join(path, "model_last_epoch.pt"), weights_only=True)["model"],
            }
    with open(os.path.join(base, "record", "eval_history_batch", "history.pickle"), "rb") as f:
        out["record"] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process runs, the two ranks' and a one-rank group's, read
    into memory; each run's directory (~190 MB a 2-D run) is removed as soon
    as it is read."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("dp")
    roots = {
        "2d": make_synthetic_modelnet(str(base / "data"), n_train=20, n_test=4, num_views=2, image_size=IMG,
                                      nclasses=NC),
        "3d": make_synthetic_nvgesture(str(base / "clips"), n_train=10, n_test=4, nclasses=NC),
        "ckpt": str(base / "one" / "train" / "model_last_epoch.pt"),
    }
    try:
        one = _runs(str(base / "one"), roots, False)
        ranks = run_ranks(_rank_runs, 2, str(base / "ranks"), roots, timeout=RUN_TIMEOUT)
        summary = {"one": _summary(str(base / "one")), "ranks": _summary(str(base / "ranks"))}
        shutil.rmtree(base / "ranks")
        world1 = _run(train, "training_guided", _bindings_2d(roots["2d"]) + ["training_loop.data_parallel=True"],
                      str(base / "world1"))
        summary["world1"] = _history(str(base / "world1"))
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(base)
    return summary, one, ranks, world1


@pytest.mark.parametrize("run", ["train", "train3d"])
def test_two_ranks_train_as_one_process(runs, run):
    summary, one, ranks, _ = runs
    head, rows = summary["one"][run]["history"]
    got_head, got_rows = summary["ranks"][run]["history"]
    assert got_head == head and len(got_rows) == len(rows) >= 1
    assert summary["ranks"][run]["files"] == summary["one"][run]["files"]
    for epoch, (r, w) in enumerate(zip(got_rows, rows)):
        for name, g, v in zip(head, r, w):
            if name not in TIME_COLUMNS:
                np.testing.assert_allclose(float(g), float(v), *(LATER_TOL if epoch else HISTORY_TOL),
                                           err_msg=f"epoch {epoch + 1} {name}")
    assert ranks[0]["steps"] == ranks[1]["steps"] == one["steps"]


def test_only_rank_zero_writes(runs):
    _, _, ranks, _ = runs
    assert ranks[1]["writes"] == []
    names = {name for _, name in ranks[0]["writes"]}
    assert {"history.csv", "history.pickle", "model_last_epoch.pt.tmp", "model_best_val.pt.torch.pt.tmp"} <= names


def test_resume_at_two_ranks_continues_the_straight_run(runs):
    summary, _, _, _ = runs
    straight, resumed = summary["ranks"]["train"], summary["ranks"]["resumed"]
    head, rows = straight["history"]
    got_head, got_rows = resumed["history"]
    assert got_head == head and len(got_rows) == len(rows) == 2
    keep = [i for i, name in enumerate(head) if name not in TIME_COLUMNS]
    assert [[r[i] for i in keep] for r in got_rows] == [[r[i] for i in keep] for r in rows]
    for key, want in straight["last"].items():
        assert torch.equal(resumed["last"][key], want), key


def test_recording_eval_at_two_ranks_equals_one_process(runs):
    summary, _, _, _ = runs
    got, want = summary["ranks"]["record"], summary["one"]["record"]
    assert sorted(got) == sorted(want)
    idx = np.concatenate([np.asarray(i) for i in got["test_indices"]])
    assert sorted(idx.tolist()) == list(range(20))  # every index once
    np.testing.assert_array_equal(idx, np.concatenate([np.asarray(i) for i in want["test_indices"]]))
    for key in ("test_loss", "test_acc", "test_acc_modal_0", "test_acc_modal_1"):
        np.testing.assert_allclose(got[key], want[key], *HISTORY_TOL, err_msg=key)
    maps_got, maps_want = got["test_squeezedmaps_array_list"][0], want["test_squeezedmaps_array_list"][0]
    assert len(maps_got) == len(maps_want) == 3
    for b_got, b_want in zip(maps_got, maps_want):
        for m_got, m_want in zip(b_got, b_want):
            for v_got, v_want in zip(m_got, m_want):
                assert v_got.shape == v_want.shape
                np.testing.assert_allclose(v_got, v_want, *MAPS_TOL)


def test_data_parallel_without_a_group_runs_one_rank(runs):
    summary, _, _, world1 = runs
    head, rows = summary["one"]["train"]["history"]
    got_head, got_rows = summary["world1"]
    keep = [i for i, name in enumerate(head) if name not in TIME_COLUMNS]
    assert got_head == head
    assert [[r[i] for i in keep] for r in got_rows] == [[r[i] for i in keep] for r in rows]
    assert not dist.is_initialized() and world1.world is not None and world1.world.size == 1
