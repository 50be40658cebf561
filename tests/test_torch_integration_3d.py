"""The 3D family end to end through both packages' entries on the CPU, on one
synthetic clip tree (``make_synthetic_nvgesture``: 10 train-file and 4 test
clips, 3 modalities of 4 frames of 32², 4 classes; 32² for the reason given
in ``tests/test_torch_models_3d.py``), at width 0.25 and B=4:

* the four training configs (``configs/training_3dcnn_{guided,random,
  weakest,adaptive}.gin``), two epochs each, from the seed alone: the port
  draws the JAX package's initial weights, (B,) clip flips and random
  controller decisions itself (``tests/test_torch_prng.py``), so the
  history agrees column for column, and the random run's decisions are the
  JAX controller's over modes 0..3;
* recording (``configs/recording_3dcnn.gin``) and flow-off
  (``configs/eval_3dcnn.gin``) in both packages from the port's guided
  checkpoint: the same pickle structure and squeeze maps, the same
  per-modality accuracies, and the flow-off averages of three modalities
  at each MMTM slot from the pickle, from the on-device reduction and from
  the JAX package's analysis;
* ``predict_`` with ``model='MMTM_3DCNN'`` in both packages on that
  checkpoint: the same predictions.csv."""

import csv
import importlib.util
import os
import pickle

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.analysis import get_rescale_weights as jax_get_rescale_weights
from greedy_multimodal_learning_tpu.data.nvgesture import make_synthetic_nvgesture
from greedy_multimodal_learning_tpu.engine import controller as jax_ctrl
from greedy_multimodal_learning_tpu.entries import eval_ as jax_eval
from greedy_multimodal_learning_tpu.entries import train as jax_train
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch import entries as port_entries
from greedy_multimodal_learning_tpu_torch.analysis import get_rescale_weights
from greedy_multimodal_learning_tpu_torch.engine import Trainer
from greedy_multimodal_learning_tpu_torch.predict import predict_ as port_predict

REPO = os.path.join(os.path.dirname(__file__), "..")
M, T, IMG, NC, BATCH, WIDTH = 3, 4, 32, 4, 4, 0.25
N_TRAIN, N_TEST = 10, 4  # valid_size 0.2: 8 train (2 steps an epoch) and 2 validation clips
CONFIGS = ("guided", "random", "weakest", "adaptive")
CLOCK_COLUMNS = ("time", "epoch_begin_time", "train_samples_per_sec")
# At lr 1e-5 the two packages' runs from identical weights, batches and flips
# agree to float32 rounding (the history tolerance of
# tests/test_torch_controllers.py); at lr 0.1 this tiny network is chaotic.
LR = 1e-5
HISTORY_RTOL, HISTORY_ATOL = 1e-4, 1e-5
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-5  # eval forwards, f32 in another summation order


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps the small convolutions from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _common(root):
    return [f"MMTM_3DCNN.nclasses={NC}", f"MMTM_3DCNN.width_multiplier={WIDTH}", f"get_nvgesturedata.root_dir='{root}'"]


def _configure(package_cfg, config, bindings):
    jax_cfg.clear_config()
    port_cfg.clear_config()
    package_cfg.parse_config_files_and_bindings([os.path.join(REPO, "configs", config)], "\n".join(bindings))


def _history(save):
    with open(os.path.join(save, "history.csv")) as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(v) for v in r] for r in rows[1:]]


class _StepLog:
    """Each port train step's (step, the decision's curation flag and target)."""

    def __init__(self):
        self.steps = []
        self._original = Trainer.train_batch

    def __enter__(self):
        log, original = self.steps, self._original

        def spy(trainer, data, flips, unlock):
            step = trainer.step
            out = original(trainer, data, flips, unlock)
            log.append((step, bool(out["curation_mode"]), int(out["caring_modality"])))
            return out

        Trainer.train_batch = spy
        return self

    def __exit__(self, *exc):
        Trainer.train_batch = self._original


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``train`` under each config from the seed alone;
    returns (root, {config: (jax dir, port dir, port steps, the port run's
    files)})."""
    base = tmp_path_factory.mktemp("int3d")
    root = make_synthetic_nvgesture(str(base / "data"), n_train=N_TRAIN, n_test=N_TEST, num_modalities=M, frames=T,
                                    image_size=IMG, nclasses=NC)
    bindings = _common(root) + [f"train.batch_size={BATCH}", f"train.lr={LR}", "training_loop.n_epochs=3"]
    out = {}
    try:
        for config in CONFIGS:
            gin = f"training_3dcnn_{config}.gin"
            _configure(jax_cfg, gin, bindings)
            jax_train(str(base / config / "jax"))
            _configure(port_cfg, gin, bindings + ["train.device='cpu'"])
            with _StepLog() as log:
                port_entries.train(str(base / config / "port"))
            jax_dir, port_dir = str(base / config / "jax"), str(base / config / "port")
            out[config] = (jax_dir, port_dir, log.steps, sorted(os.listdir(port_dir)))
            # the guided port run's checkpoints feed the eval tests; the others'
            # are only listed (~25 MB each)
            for d in (jax_dir,) if config == "guided" else (jax_dir, port_dir):
                for name in os.listdir(d):
                    if name.endswith((".pt", ".pkl")):
                        os.remove(os.path.join(d, name))
    finally:
        jax_cfg.clear_config()
        port_cfg.clear_config()
    return root, out


@pytest.mark.parametrize("config", CONFIGS)
def test_training_configs_give_the_jax_history(runs, config):
    _, dirs = runs
    jax_dir, port_dir, steps, artifacts = dirs[config]
    j_cols, j_rows = _history(jax_dir)
    p_cols, p_rows = _history(port_dir)
    assert p_cols == j_cols and len(p_rows) == len(j_rows) == 2
    for col in ("acc_modal_0", "acc_modal_1", "acc_modal_2", "val_acc_modal_2", "test_acc_modal_2"):
        assert col in p_cols, col
    assert np.isfinite(np.array(p_rows)).all()
    for name in ("history.pickle", "model_best_val.pt", "model_last_epoch.pt", "model_last_epoch.pt.torch.pt"):
        assert name in artifacts, name
    assert [s[0] for s in steps] == list(range(4))
    if config == "random":
        # the JAX controller's decisions (key PRNGKey(777), one split a step)
        # over modes 0..3 (mode m > 0 curates modality m - 1), unlocked from
        # epoch 2 (step 2)
        state, want = jax_ctrl.init_controller_state(M, 777), []
        for t in range(4):
            state = jax_ctrl.random_update(state, jnp.ones(2 * M), jnp.ones(2 * M), jnp.asarray(t >= 2),
                                           num_modalities=M)
            want.append((bool(state.curation_mode), int(state.caring_modality)))
        assert [(on, caring) for _, on, caring in steps] == want
    keep = [i for i, c in enumerate(j_cols) if c not in CLOCK_COLUMNS]
    np.testing.assert_allclose(np.array(p_rows)[:, keep], np.array(j_rows)[:, keep], rtol=HISTORY_RTOL,
                               atol=HISTORY_ATOL, err_msg=str([j_cols[i] for i in keep]))


@pytest.fixture(scope="module")
def evals(runs, tmp_path_factory):
    """Recording, then flow-off, in both packages from the port's guided
    checkpoint (the port's guided run holds the train indices)."""
    root, dirs = runs
    run = dirs["guided"][1]
    ckpt = os.path.join(run, "model_last_epoch.pt")
    base = tmp_path_factory.mktemp("eval3d")
    out = {}
    try:
        for name, package_cfg, entry, extra in (("jax", jax_cfg, jax_eval, []),
                                                ("port", port_cfg, port_entries.eval_, ["eval_.device='cpu'"])):
            rec, off = str(base / name / "rec"), str(base / name / "off")
            common = _common(root) + [f"eval_.batch_size={BATCH}", f"eval_.pretrained_weights_path='{ckpt}'", *extra]
            _configure(package_cfg, "recording_3dcnn.gin", common)
            entry(rec)
            _configure(package_cfg, "eval_3dcnn.gin", common + [
                f"MMTM_3DCNN.mmtm_rescale_eval_file_path='{os.path.join(rec, 'eval_history_batch')}'",
                f"MMTM_3DCNN.mmtm_rescale_training_file_path='{run}'",
            ])
            entry(off)
            out[name] = (rec, off)
    finally:
        jax_cfg.clear_config()
        port_cfg.clear_config()
    return out


def test_recording_matches_jax(evals):
    recordings = {}
    for name, (rec, _) in evals.items():
        with open(os.path.join(rec, "eval_history_batch", "history.pickle"), "rb") as f:
            recordings[name] = pickle.load(f)
    j, p = recordings["jax"], recordings["port"]
    assert sorted(p) == sorted(j)
    maps_j, maps_p = j["test_squeezedmaps_array_list"][0], p["test_squeezedmaps_array_list"][0]
    # 10 train-file clips (valid_size=0) in batches of 4, real rows only: 3 MMTMs x 3 modalities
    shapes = [[[np.shape(v) for v in m] for m in b] for b in maps_p]
    assert shapes == [[[(rows, int(c * WIDTH))] * M for c in (128, 256, 512)] for rows in (4, 4, 2)]
    assert shapes == [[[np.shape(v) for v in m] for m in b] for b in maps_j]
    np.testing.assert_array_equal(np.asarray(p["test_indices"][0]), np.asarray(j["test_indices"][0]))
    for bp, bj in zip(maps_p, maps_j):
        for mp_, mj in zip(bp, bj):
            for vp, vj in zip(mp_, mj):
                np.testing.assert_allclose(np.asarray(vp), np.asarray(vj), rtol=EVAL_RTOL, atol=EVAL_ATOL)


def test_flow_off_accuracies_match_jax(evals):
    rows = {}
    for name, (_, off) in evals.items():
        with open(os.path.join(off, "eval_history_batch", "history.csv")) as f:
            rows[name] = list(csv.DictReader(f))[-1]
    cols = ["test_loss", "test_acc"] + [f"test_acc_modal_{m}" for m in range(M)]
    got = np.array([float(rows["port"][c]) for c in cols])
    want = np.array([float(rows["jax"][c]) for c in cols])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=EVAL_RTOL, atol=EVAL_ATOL, err_msg=str(cols))


def test_rescale_means_cover_three_modalities(runs, evals, tmp_path):
    """The flow-off averages of the 3-D family: one (C,) mean per modality
    at each of the three MMTM slots, the same from the pickle (host) and
    from ``evalution_loop.ondevice_rescale`` (device), and the JAX
    package's ``get_rescale_weights`` over its own recording."""
    root, dirs = runs
    run = dirs["guided"][1]
    od = str(tmp_path / "od")
    try:
        _configure(port_cfg, "recording_3dcnn.gin", _common(root) + [
            f"eval_.batch_size={BATCH}", "eval_.device='cpu'",
            f"eval_.pretrained_weights_path='{os.path.join(run, 'model_last_epoch.pt')}'",
            "evalution_loop.ondevice_rescale=True", f"evalution_loop.ondevice_rescale_training_path='{run}'",
        ])
        port_entries.eval_(od)
    finally:
        port_cfg.clear_config()
    host = get_rescale_weights(os.path.join(evals["port"][0], "eval_history_batch"), run)
    device = get_rescale_weights(os.path.join(od, "eval_history_batch"), run)
    reference = jax_get_rescale_weights(os.path.join(evals["jax"][0], "eval_history_batch"), run)
    assert host[0] is None and device[0] is None
    for position, width in zip((1, 2, 3), (128, 256, 512)):
        assert [m.shape for m in host[position]] == [(int(width * WIDTH),)] * M
        for h, d, r in zip(host[position], device[position], reference[position]):
            np.testing.assert_allclose(d, h, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(h, r, rtol=EVAL_RTOL, atol=EVAL_ATOL)


def _jax_predict():
    spec = importlib.util.spec_from_file_location("_jax_predict_entry", os.path.join(REPO, "predict.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.predict_


def test_predict_matches_jax(runs, tmp_path):
    root, dirs = runs
    ckpt = os.path.join(dirs["guided"][1], "model_last_epoch.pt")
    bindings = _common(root) + ["predict_.model='MMTM_3DCNN'", f"predict_.batch_size={BATCH}",
                                f"predict_.pretrained_weights_path='{ckpt}'"]
    try:
        _configure(jax_cfg, "training_3dcnn_guided.gin", bindings)
        jax_csv = _jax_predict()(str(tmp_path / "jax"))
        _configure(port_cfg, "training_3dcnn_guided.gin", bindings + ["predict_.device='cpu'"])
        port_csv, out = port_predict(str(tmp_path / "port"))
    finally:
        jax_cfg.clear_config()
        port_cfg.clear_config()
    read = lambda path: list(csv.DictReader(open(path)))
    jax_rows, port_rows = read(jax_csv), read(port_csv)
    assert len(port_rows) == N_TEST and len(out["logits"]) == M
    for col in ("index", "model", "true_class", "predicted_class"):
        assert [r[col] for r in port_rows] == [r[col] for r in jax_rows], col
    np.testing.assert_allclose([float(r["confidence"]) for r in port_rows],
                               [float(r["confidence"]) for r in jax_rows], atol=1e-4)
