"""Tensor parallelism through the port's entries on the CPU (the counterpart
of ``tests/test_integration_dp.py``, whose runs bind ``model_parallel =
2``): ``train`` and the recording ``eval_`` with ``data_parallel=True`` and
``model_parallel=2`` at four spawned gloo ranks, dp 2 × tp 2 (one thread
each, a 60 s group timeout, a deadline on the run), against the same entries
in one process, SGD with momentum 0.9:

* ``train`` at dp 2 × tp 2 writes the one-process run's files and
  ``history.csv`` columns, epochs [1, 2], finite metrics within
  ``HISTORY_TOL`` of the one process's in the first epoch and ``LATER_TOL``
  after it (the tolerances of ``tests/test_torch_integration_dp.py``);
* its checkpoint has the names and full shapes a one-process run writes,
  its momentum buffers whole; it loads in the port at tp 1, weights and
  training state, and in the JAX package's ``load_into_state``;
* a one-process (tp 1) run's checkpoint resumes at tp 2 and continues as
  the straight one-process run;
* the recording ``eval_`` at tp 2, plain and with
  ``evalution_loop.fold_bn_eval``, writes every index once in the one
  process's order, its squeeze maps within ``MAPS_TOL`` of the one
  process's same pass;
* ``model_parallel=2`` without ``data_parallel`` runs the plain path, as
  the JAX package ignores it there.
"""

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
from greedy_multimodal_learning_tpu_torch.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch.engine import load_weights, make_optimizer
from greedy_multimodal_learning_tpu_torch.engine.checkpoint import load_training_state
from greedy_multimodal_learning_tpu_torch.entries import eval_, train
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN
from greedy_multimodal_learning_tpu_torch.parallel import tensor as tensor_parallel
from greedy_multimodal_learning_tpu_torch.parallel.launch import run_ranks

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = {name: os.path.join(REPO, "configs", f"{name}.gin") for name in ("training_guided", "recording")}
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
RUN_TIMEOUT = 300.0  # seconds for every rank of the spawned runs
RANKS, TP = 4, 2
IMG, NC, BATCH = 32, 4, 8
HISTORY_TOL = (1e-4, 1e-5)  # (rtol, atol) of the first epoch's metrics, the ranks against one process
LATER_TOL = (1e-2, 1e-5)  # of the later epochs' metrics
MAPS_TOL = (1e-5, 1e-5)  # the recorded squeeze maps: the kernel's sq tolerance
TIME_COLUMNS = ("time", "epoch_begin_time", "train_samples_per_sec")


def _bindings(root):
    return [
        f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", f"MMTM_MVCNN.nclasses={NC}",
        f"train.batch_size={BATCH}", "train.lr=0.001", "train.momentum=0.9", "train.device='cpu'",
        "training_loop.n_epochs=3", f"training_loop.model_parallel={TP}",
    ]


def _record_bindings(root, ckpt, data_parallel, fold):
    # the recording pass over the whole train file (20 samples, the third
    # batch of 8 half padding: the second data index's rows of it all padding)
    return _bindings(root) + [
        "get_mvdcndata.valid_size=0", "eval_.target_data_split='train'", "eval_.batch_size=8", "eval_.device='cpu'",
        f"evalution_loop.data_parallel={data_parallel}", f"evalution_loop.model_parallel={TP}",
        f"evalution_loop.fold_bn_eval={fold}", f"eval_.pretrained_weights_path='{ckpt}'",
    ]


def _run(entry, config, bindings, save_path):
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings([CONFIGS[config]], "\n".join(bindings))
    try:
        return entry(save_path)
    finally:
        port_cfg.clear_config()


def _runs(base, roots, data_parallel):
    """The entry runs of one process or of one rank, under ``base``:
    ``train`` straight, a one-process run's first epoch resumed (tp 1 ->
    the caller's), and the recording, plain and folded, on the one-process
    run's checkpoint."""
    b = _bindings(roots["2d"]) + [f"training_loop.data_parallel={data_parallel}"]
    trainer = _run(train, "training_guided", b, os.path.join(base, "train"))
    out = {"steps": trainer.step, "world": trainer.world, "sharded": tensor_parallel.is_sharded(trainer.model)}
    _run(train, "training_guided", b + ["training_loop.resume=True"], os.path.join(base, "resumed"))
    for fold in (False, True):
        _run(eval_, "recording", _record_bindings(roots["2d"], roots["ckpt"], data_parallel, fold),
             os.path.join(base, f"record_fold{fold}"))
    return out


def _rank_runs(rank, base, roots):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", timeout=GROUP_TIMEOUT)
    try:
        out = _runs(base, roots, True)
    finally:
        dist.destroy_process_group()
    out["world"] = (out["world"].size, out["world"].model_size, out["world"].data_index, out["world"].model_index)
    return out


def _history(path):
    with open(os.path.join(path, "history.csv")) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _summary(base):
    """What the tests read of the runs under ``base``: each training run's
    history, files and last checkpoint with its sidecar, and the
    recordings' pickles."""
    out = {}
    for run in ("train", "resumed"):
        path = os.path.join(base, run)
        ckpt = os.path.join(path, "model_last_epoch.pt")
        out[run] = {
            "history": _history(path),
            "files": sorted(os.path.relpath(os.path.join(d, f), path) for d, _, files in os.walk(path)
                            for f in files),
            "last": torch.load(ckpt, weights_only=True)["model"],
            "sidecar": torch.load(f"{ckpt}.torch.pt", weights_only=True),
        }
    for fold in (False, True):
        with open(os.path.join(base, f"record_fold{fold}", "eval_history_batch", "history.pickle"), "rb") as f:
            out[f"record_fold{fold}"] = pickle.load(f)
    return out


def _jax_loads(path):
    """The JAX package's ``load_into_state`` of ``path`` into a fresh state,
    back in the port's names."""
    import jax
    import jax.numpy as jnp

    from greedy_multimodal_learning_tpu.engine import create_train_state
    from greedy_multimodal_learning_tpu.engine.checkpoint import load_into_state
    from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
    from greedy_multimodal_learning_tpu_torch.engine import state_dict_from_jax

    fresh = create_train_state(JaxMMTMMVCNN(nclasses=NC), None, jax.random.PRNGKey(1),
                               jnp.zeros((2, 2, IMG, IMG, 3), jnp.float32))
    state = jax.device_get(load_into_state(fresh, path))
    return state_dict_from_jax(state.params, state.batch_stats, {})


def _port_loads(path):
    """The tp 1 port's loads of ``path``: its weights into a model, and its
    training state (weights, momentum) into a model and an SGD."""
    model = MMTMMVCNN(nclasses=NC)
    load_weights(model, path)
    resumed = MMTMMVCNN(nclasses=NC)
    optimizer = make_optimizer(resumed.parameters(), lr=0.001, momentum=0.9)
    load_training_state(resumed, optimizer, path)
    return {"weights": {k: v.clone() for k, v in model.state_dict().items()},
            "momentum": {n: tuple(optimizer.state[p]["momentum_buffer"].shape) for n, p in resumed.named_parameters()},
            "shapes": {n: tuple(p.shape) for n, p in resumed.named_parameters()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process runs and the four ranks', read into memory; each
    run's directory is removed as soon as it is read."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("tp")
    roots = {
        "2d": make_synthetic_modelnet(str(base / "data"), n_train=20, n_test=4, num_views=2, image_size=IMG,
                                      nclasses=NC),
        "ckpt": str(base / "one" / "train" / "model_last_epoch.pt"),
    }
    try:
        # a one-process run's first epoch, which both the one process and the
        # ranks resume to the straight run's two
        _run(train, "training_guided", _bindings(roots["2d"]) + ["training_loop.n_epochs=2"], str(base / "first"))
        for who in ("one", "ranks"):
            shutil.copytree(base / "first", base / who / "resumed")
        one = _runs(str(base / "one"), roots, False)
        ranks = run_ranks(_rank_runs, RANKS, str(base / "ranks"), roots, timeout=RUN_TIMEOUT)
        summary = {"one": _summary(str(base / "one")), "ranks": _summary(str(base / "ranks"))}
        tp_ckpt = str(base / "ranks" / "train" / "model_last_epoch.pt")
        loads = {"port": _port_loads(tp_ckpt), "jax": _jax_loads(tp_ckpt)}
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(base)
    return summary, one, ranks, loads


def _check_history(got, want):
    head, rows = want
    got_head, got_rows = got
    assert got_head == head and len(got_rows) == len(rows) >= 1
    for epoch, (r, w) in enumerate(zip(got_rows, rows)):
        for name, g, v in zip(head, r, w):
            if name not in TIME_COLUMNS:
                assert np.isfinite(float(g)), (epoch, name)
                np.testing.assert_allclose(float(g), float(v), *(LATER_TOL if epoch else HISTORY_TOL),
                                           err_msg=f"epoch {epoch + 1} {name}")


def test_train_at_dp2_tp2_as_one_process(runs):
    summary, one, ranks, _ = runs
    got, want = summary["ranks"]["train"], summary["one"]["train"]
    _check_history(got["history"], want["history"])
    assert [int(r[0]) for r in got["history"][1]] == [1, 2]
    assert got["files"] == want["files"]
    assert [r["world"] for r in ranks] == [(RANKS, TP, r // TP, r % TP) for r in range(RANKS)]
    assert all(r["sharded"] and r["steps"] == one["steps"] for r in ranks)


def test_tp2_checkpoint_is_whole(runs):
    """The names and full shapes of the one-process checkpoint, the
    momentum buffers of the sidecar whole."""
    summary, _, _, _ = runs
    got, want = summary["ranks"]["train"], summary["one"]["train"]
    assert {k: v.shape for k, v in got["last"].items()} == {k: v.shape for k, v in want["last"].items()}
    assert sorted(got["sidecar"]["mmtm"]) == sorted(want["sidecar"]["mmtm"])
    got_opt, want_opt = got["sidecar"]["optimizer"]["state"], want["sidecar"]["optimizer"]["state"]
    assert {k: v["momentum_buffer"].shape for k, v in got_opt.items()} == {
        k: v["momentum_buffer"].shape for k, v in want_opt.items()}
    assert sum(v["momentum_buffer"].shape[0] in (256, 512) for v in got_opt.values()) >= 26


def test_tp2_checkpoint_loads_at_tp1_in_the_port_and_the_jax_package(runs):
    summary, _, _, loads = runs
    last = summary["ranks"]["train"]["last"]
    for key, value in loads["port"]["weights"].items():
        if key in last:
            assert torch.equal(value, last[key]), key
    assert loads["port"]["momentum"] == loads["port"]["shapes"]
    params = {n for n, _ in MMTMMVCNN(nclasses=NC).named_parameters()}
    assert params <= set(loads["jax"])
    for key, value in loads["jax"].items():
        assert torch.equal(value, last[key]), key


def test_tp1_checkpoint_resumes_at_tp2(runs):
    """The one-process run's first epoch, resumed at dp 2 × tp 2, continues
    as the one process's resume of it."""
    summary, _, _, _ = runs
    got, want = summary["ranks"]["resumed"], summary["one"]["resumed"]
    _check_history(got["history"], want["history"])
    assert [int(r[0]) for r in got["history"][1]] == [1, 2]


@pytest.mark.parametrize("fold", [False, True])
def test_recording_eval_at_tp2_equals_one_process(runs, fold):
    summary, _, _, _ = runs
    got, want = summary["ranks"][f"record_fold{fold}"], summary["one"][f"record_fold{fold}"]
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


def test_model_parallel_without_data_parallel_runs_the_plain_path(runs):
    """The one-process runs bind ``model_parallel=2`` with
    ``data_parallel=False``: no world, nothing sharded."""
    _, one, _, _ = runs
    assert one["world"] is None and not one["sharded"] and not dist.is_initialized()
