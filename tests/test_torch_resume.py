"""``training_loop.resume`` in the port: a run stopped after an epoch and
resumed from ``model_last_epoch.pt`` and its ``.torch.pt`` sidecar ends where
the same run taken straight through ends (history, parameters, buffers,
controller, step), on the CPU (tests/test_resume.py holds the JAX package to
the same)."""

import csv
import os
import pickle

import numpy as np
import pytest

import torch

from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.engine.framework import Trainer
from greedy_multimodal_learning_tpu_torch.entries import train

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs", "training_guided.gin")
TOL = 1e-6
CLOCK_COLUMNS = ("time", "epoch_begin_time", "train_samples_per_sec")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps this module's small convolutions from oversubscribing the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_port_config():
    port_cfg.clear_config()
    yield
    port_cfg.clear_config()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_modelnet(str(tmp_path_factory.mktemp("data")), n_train=8, n_test=4, num_views=2,
                                   image_size=32, nclasses=4)


def _run(root, save, n_epochs, *extra):
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings([CONFIG], "\n".join([
        f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", "MMTM_MVCNN.nclasses=4",
        "train.device='cpu'", "train.batch_size=4", "train.lr=0.01", f"training_loop.n_epochs={n_epochs}",
        "MMTM_mitigate.use_pallas=True", *extra,
    ]))
    return train(str(save))


def _history(save):
    with open(os.path.join(save, "history.csv")) as f:
        rows = list(csv.DictReader(f))
    return [{k: float(v) for k, v in r.items() if k not in CLOCK_COLUMNS} for r in rows]


def _assert_rows_equal(got, want):
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        np.testing.assert_allclose(list(g.values()), list(w.values()), rtol=TOL, atol=TOL,
                                   err_msg=f"epoch {w['epoch']}")


def _assert_same_state(got: Trainer, want: Trainer):
    assert got.step == want.step
    for k, v in want.model.state_dict().items():
        np.testing.assert_allclose(got.model.state_dict()[k].double().numpy(), v.double().numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)
    for k, v in want.ctrl.as_dict().items():
        np.testing.assert_allclose(getattr(got.ctrl, k).double().numpy(), v.double().numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert got.get_lr() == pytest.approx(want.get_lr(), rel=TOL)


# momentum 0.9 needs the optimizer's momentum buffers back; a plateau on the
# epoch number (min mode: it never improves) with patience 0 cuts the
# learning rate after every epoch from the second, which the resumed run does
# only with the history replayed into the callback
@pytest.mark.parametrize("extra", [
    (),
    ("train.momentum=0.9", "ReduceLROnPlateau_PyTorch.metric='epoch'", "ReduceLROnPlateau_PyTorch.patience=0"),
], ids=["plain", "momentum_plateau"])
def test_resumed_run_equals_straight_run(root, tmp_path, extra):
    straight = _run(root, tmp_path / "straight", 3, *extra)  # epochs 1 and 2
    _run(root, tmp_path / "resumed", 2, *extra)  # epoch 1
    saved = torch.load(tmp_path / "resumed" / "model_last_epoch.pt.torch.pt", weights_only=True)
    restored = {}
    original = Trainer.restore

    def spy(self, filepath):
        original(self, filepath)
        restored.update(step=self.step, ctrl={k: v.clone() for k, v in self.ctrl.as_dict().items()})

    Trainer.restore = spy
    try:
        resumed = _run(root, tmp_path / "resumed", 3, "training_loop.resume=True", *extra)
    finally:
        Trainer.restore = original
    side = torch.load(tmp_path / "resumed" / "model_last_epoch.pt.torch.pt", weights_only=True)
    assert restored["step"] == saved["step"] == 2  # 7 train samples (one in val) in batches of 4, one epoch
    assert restored["ctrl"].keys() == saved["controller"].keys()
    for k, v in saved["controller"].items():
        assert torch.equal(restored["ctrl"][k], v), k
    assert side["step"] == resumed.step == straight.step == 4
    _assert_rows_equal(_history(tmp_path / "resumed"), _history(tmp_path / "straight"))
    _assert_same_state(resumed, straight)
    if extra:
        assert resumed.get_lr() == pytest.approx(0.01 * 0.3)
    best = [torch.load(tmp_path / run / "model_best_val.pt.torch.pt", weights_only=True)["step"]
            for run in ("resumed", "straight")]
    assert best[0] == best[1]  # the best-val checkpoint's best came back with the history
    with open(tmp_path / "resumed" / "history.pickle", "rb") as f:
        H = pickle.load(f)
    assert H["epoch"] == [1, 2] and len(H["train_indices"]) == 2


def test_checkpoint_every_truncates_history(root, tmp_path):
    """With ``checkpoint_every=2`` the last checkpoint (epoch 2) is older than
    the history (epoch 3): the resume cuts the history back to epoch 2 and
    trains epoch 3 again (tests/test_resume.py:74)."""
    save = tmp_path / "run"
    _run(root, save, 4, "training_loop.checkpoint_every=2")
    first = _history(save)
    assert [r["epoch"] for r in first] == [1, 2, 3]
    side = torch.load(save / "model_last_epoch.pt.torch.pt", weights_only=True)
    assert side["step"] == 4  # written at epoch 2
    resumed = _run(root, save, 5, "training_loop.checkpoint_every=2", "training_loop.resume=True")
    straight = _run(root, tmp_path / "straight", 5)
    got = _history(save)
    assert [r["epoch"] for r in got] == [1, 2, 3, 4]
    _assert_rows_equal(got[:2], first[:2])
    _assert_rows_equal(got, _history(tmp_path / "straight"))
    _assert_same_state(resumed, straight)
    with open(save / "history.pickle", "rb") as f:
        H = pickle.load(f)
    assert len(H["train_indices"]) == len(H["epoch"]) == 4


def test_resume_without_sidecar_raises(root, tmp_path):
    save = tmp_path / "run"
    _run(root, save, 2)
    os.remove(save / "model_last_epoch.pt.torch.pt")
    with pytest.raises(FileNotFoundError, match=r"model_last_epoch\.pt\.torch\.pt"):
        _run(root, save, 3, "training_loop.resume=True")


def test_resume_without_checkpoint_starts_fresh(root, tmp_path):
    trainer = _run(root, tmp_path / "run", 2, "training_loop.resume=True")
    assert trainer.step == 2
    assert [r["epoch"] for r in _history(tmp_path / "run")] == [1]
