"""The port's multi-checkpoint sweep (``greedy_multimodal_learning_tpu_torch/engine/sweep.py``
and its entry ``eval_sweep.py``) on the CPU:

* each checkpoint's row equals a separate ``eval_`` of it (rtol 1e-5, as
  ``tests/test_sweep.py:37-39`` holds the JAX sweep), without and with
  ``fold_bn`` (against ``eval_`` with ``evalution_loop.fold_bn_eval``);
* the rows match the JAX package's ``eval_sweep.py`` on the same
  checkpoints, and ``sweep.csv`` has the JAX entry's columns;
* a glob never takes a sidecar (``.torch.pt``, ``.jax.pkl``) for a
  checkpoint."""

import csv
import os
import shutil

import numpy as np
import pytest
import torch

from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch import eval_sweep as sweep_entry
from greedy_multimodal_learning_tpu_torch.engine.sweep import eval_sweep
from greedy_multimodal_learning_tpu_torch.entries import eval_, train
from greedy_multimodal_learning_tpu_torch.eval_sweep import checkpoint_paths, eval_sweep_

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs", "training_random.gin")
NC = 4
SEQ_RTOL = 1e-5  # tests/test_sweep.py:37-39
JAX_TOL = (1e-4, 1e-5)  # (rtol, atol): f32 forwards of the two packages
METRICS = ("acc", "acc_modal_0", "acc_modal_1", "loss")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps the small convolutions from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each full-width checkpoint here is ~90 MB: a test's files go when it
    ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _clean_configs():
    port_cfg.clear_config()
    jax_cfg.clear_config()
    yield
    port_cfg.clear_config()
    jax_cfg.clear_config()


def _data(root):
    return [f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", f"MMTM_MVCNN.nclasses={NC}"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two epochs of the port's ``train`` (random controller): two
    checkpoints with their ``.torch.pt`` sidecars."""
    base = tmp_path_factory.mktemp("sweep")
    root = make_synthetic_modelnet(str(base / "data"), n_train=8, n_test=6, num_views=2, image_size=32, nclasses=NC)
    save = str(base / "run")
    port_cfg.parse_config_files_and_bindings([CONFIG], "\n".join(_data(root) + [
        "train.device='cpu'", "train.batch_size=4", "training_loop.n_epochs=3"]))
    train(save)
    port_cfg.clear_config()
    yield root, save, [os.path.join(save, "model_best_val.pt"), os.path.join(save, "model_last_epoch.pt")], base
    shutil.rmtree(base, ignore_errors=True)


def _sweep_rows(csv_path):
    with open(csv_path) as f:
        return list(csv.DictReader(f))


def _port_sweep(root, paths, out):
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings([CONFIG], "\n".join(_data(root) + [
        f"eval_sweep_.checkpoints={paths!r}", "eval_sweep_.batch_size=4", "eval_sweep_.device='cpu'"]))
    return eval_sweep_(out)


def _eval(root, path, out, *extra):
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings([CONFIG], "\n".join(_data(root) + [
        f"eval_.pretrained_weights_path='{path}'", "eval_.batch_size=4", "eval_.device='cpu'", *extra]))
    eval_(out)
    with open(os.path.join(out, "eval_history_batch", "history.csv")) as f:
        row = list(csv.DictReader(f))[-1]
    return {k: float(row[f"test_{k}"]) for k in METRICS}


@pytest.mark.parametrize("fold_bn", [False, True], ids=["unfolded", "fold_bn"])
def test_sweep_equals_sequential_eval(run, fold_bn, tmp_path, monkeypatch):
    """The sweep function over the entry's model, loader and checkpoint
    states, against ``eval_`` of each checkpoint."""
    root, _, paths, _ = run
    seen = {}

    def capture(model, states, generator, steps=None, fold_bn=False):
        seen.update(model=model, states=states, generator=generator)
        return eval_sweep(model, states, generator, steps, fold_bn)

    monkeypatch.setattr(sweep_entry, "eval_sweep", capture)
    _port_sweep(root, paths, str(tmp_path / "entry"))
    swept = eval_sweep(seen["model"], seen["states"], seen["generator"], fold_bn=fold_bn)
    assert swept[0]["loss"] != swept[1]["loss"]
    extra = ["evalution_loop.fold_bn_eval=True"] if fold_bn else []
    for k, (path, row) in enumerate(zip(paths, swept)):
        seq = _eval(root, path, str(tmp_path / f"eval{k}"), *extra)
        for name in METRICS:
            np.testing.assert_allclose(row[name], seq[name], rtol=SEQ_RTOL, err_msg=f"{path} {name}")


def test_sweep_entry_matches_the_jax_entry(run, tmp_path):
    from eval_sweep import eval_sweep_ as jax_eval_sweep_

    root, _, paths, _ = run
    jax_cfg.parse_config_files_and_bindings([CONFIG], "\n".join(_data(root) + [
        f"eval_sweep_.checkpoints={paths!r}", "eval_sweep_.batch_size=4"]))
    with open(jax_eval_sweep_(str(tmp_path / "jax"))) as f:
        jax_header = f.readline()
    jax_rows = _sweep_rows(str(tmp_path / "jax" / "sweep.csv"))
    csv_path = _port_sweep(root, paths, str(tmp_path / "port"))
    with open(csv_path) as f:
        assert f.readline() == jax_header == "checkpoint," + ",".join(METRICS) + "\n"
    port_rows = _sweep_rows(csv_path)
    assert [r["checkpoint"] for r in port_rows] == [r["checkpoint"] for r in jax_rows] == paths
    for p, j in zip(port_rows, jax_rows):
        for name in METRICS:
            np.testing.assert_allclose(float(p[name]), float(j[name]), *JAX_TOL, err_msg=f"{p['checkpoint']} {name}")


def test_globs_skip_both_sidecars(run, tmp_path):
    _, save, paths, _ = run
    shutil.copy(paths[1], paths[1] + ".jax.pkl")  # a stand-in file: only its name matters here
    try:
        assert checkpoint_paths([os.path.join(save, "model_*")]) == sorted(paths)
        assert os.path.exists(paths[0] + ".torch.pt")
    finally:
        os.remove(paths[1] + ".jax.pkl")
    with pytest.raises(FileNotFoundError, match="no checkpoint matches"):
        checkpoint_paths([os.path.join(save, "nothing_*.pt")])
    with pytest.raises(ValueError, match="empty"):
        checkpoint_paths([])
