"""The eval slice end to end on the CPU: one guided training run of the port
writes its checkpoints and ``history.pickle``; then the JAX package's
``eval_`` and the port's run the recording pass (``configs/recording.gin``)
and the flow-off pass (``configs/eval.gin``) on the same checkpoint and data,
and their pickles, rescale weights, logits and histories agree.

The run takes seven epochs and the passes load ``model_last_epoch.pt``: after
a few steps of batch 4 the BatchNorm running statistics are far from the
batches', and the eval activations reach 1e7, where float32 rounding alone
exceeds the tolerances below."""

import csv
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import torch

from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.analysis import get_rescale_weights as jax_get_rescale_weights
from greedy_multimodal_learning_tpu.bootstrap import build_model_and_loaders as jax_build
from greedy_multimodal_learning_tpu.bootstrap import init_state as jax_init_state
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu.engine.framework import Trainer as JaxTrainer
from greedy_multimodal_learning_tpu.entries import eval_ as jax_eval
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.analysis import get_rescale_weights
from greedy_multimodal_learning_tpu_torch.analysis.ondevice_rescale import (
    RESCALE_MEANS_FILENAME,
    RescaleMeanAccumulator,
)
from greedy_multimodal_learning_tpu_torch.data import get_mvdcndata
from greedy_multimodal_learning_tpu_torch.entries import eval_, train

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = {name: os.path.join(REPO, "configs", f"{name}.gin") for name in ("training_guided", "recording", "eval")}
IMG, NC, BATCH = 32, 4, 4
STAT_RTOL, STAT_ATOL = 1e-3, 1e-5  # intermediate statistics, tests/test_torch_parity.py:190-206
# f32 rounding through the towers is absolute at the scale of the
# activations: a near-zero squeeze of a map whose largest entry is ~100
# carries ~1e-5 of it, so the absolute tolerance grows with that scale
STAT_ATOL_PER_SCALE = 1e-6
LOGIT_RTOL, LOGIT_ATOL = 5e-3, 5e-4  # logits, tests/test_torch_parity.py:163
LOSS_RTOL = 1e-4
CKPT = "model_last_epoch.pt"


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
def _clean_configs():
    port_cfg.clear_config()
    jax_cfg.clear_config()
    yield
    port_cfg.clear_config()
    jax_cfg.clear_config()


def _data(root):
    return [f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", f"MMTM_MVCNN.nclasses={NC}"]


def _port(config, bindings):
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings([CONFIGS[config]], "\n".join(bindings))


def _jax(config, bindings):
    jax_cfg.clear_config()
    jax_cfg.parse_config_files_and_bindings([CONFIGS[config]], "\n".join(bindings))


def _recording(root, run):
    return _data(root) + [f"eval_.batch_size={BATCH}", f"eval_.pretrained_weights_path='{run}/{CKPT}'"]


def _flow_off(root, run, recording):
    return _recording(root, run) + [
        f"MMTM_MVCNN.mmtm_rescale_eval_file_path='{recording}/eval_history_batch'",
        f"MMTM_MVCNN.mmtm_rescale_training_file_path='{run}'",
    ]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A guided port run, then each package's recording and flow-off passes
    on its checkpoint (the port's with the kernel path's plain version)."""
    base = tmp_path_factory.mktemp("eval")
    root = make_synthetic_modelnet(str(base / "data"), n_train=12, n_test=8, num_views=2, image_size=IMG, nclasses=NC)
    run = str(base / "run")
    _port("training_guided", _data(root) + [
        "train.device='cpu'", f"train.batch_size={BATCH}", "train.lr=0.01", "training_loop.n_epochs=8",
    ])
    train(run)
    dirs = {pkg: {p: str(base / f"{pkg}_{p}") for p in ("rec", "off")} for pkg in ("jax", "port")}
    _jax("recording", _recording(root, run))
    jax_eval(dirs["jax"]["rec"])
    _jax("eval", _flow_off(root, run, dirs["jax"]["rec"]))
    jax_eval(dirs["jax"]["off"])
    pallas = ["MMTM_mitigate.use_pallas=True", "eval_.device='cpu'"]
    _port("recording", _recording(root, run) + pallas)
    eval_(dirs["port"]["rec"])
    _port("eval", _flow_off(root, run, dirs["port"]["rec"]) + pallas)
    off_trainer = eval_(dirs["port"]["off"])
    port_cfg.clear_config()
    jax_cfg.clear_config()
    return root, run, dirs, off_trainer


def _history(path):
    with open(os.path.join(path, "eval_history_batch", "history.pickle"), "rb") as f:
        return pickle.load(f)


def _columns(path):
    with open(os.path.join(path, "eval_history_batch", "history.csv")) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _assert_stats_close(got, want):
    atol = max(STAT_ATOL, STAT_ATOL_PER_SCALE * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=STAT_RTOL, atol=atol)


def _dataset_order(H, key="test_squeezedmaps_array_list"):
    """[module][view] (samples, C) maps in dataset order."""
    order = np.argsort(np.asarray(H["test_indices"][0]))
    batches = H[key][0]
    return [[np.concatenate([b[m][v] for b in batches])[order] for v in range(2)] for m in range(3)]


def test_recording_pickles_match(ws):
    _, _, dirs, _ = ws
    j, p = _history(dirs["jax"]["rec"]), _history(dirs["port"]["rec"])
    assert list(p) == list(j)
    jb, pb = j["test_squeezedmaps_array_list"][0], p["test_squeezedmaps_array_list"][0]
    assert len(pb) == len(jb) == 3  # 12 train samples (valid_size=0) in batches of 4
    for jbatch, pbatch in zip(jb, pb):
        assert len(pbatch) == 3 and all(len(m) == 2 for m in pbatch)
        for jm, pm in zip(jbatch, pbatch):
            assert [v.shape for v in pm] == [v.shape for v in jm]
            assert all(v.dtype == np.float32 for v in pm)
    assert sorted(p["test_indices"][0].tolist()) == sorted(j["test_indices"][0].tolist()) == list(range(12))
    for jm, pm in zip(_dataset_order(j), _dataset_order(p)):
        for jv, pv in zip(jm, pm):
            _assert_stats_close(pv, jv)


def test_rescale_weights_match(ws):
    _, run, dirs, _ = ws
    want = jax_get_rescale_weights(os.path.join(dirs["jax"]["rec"], "eval_history_batch"), run)
    got = get_rescale_weights(os.path.join(dirs["port"]["rec"], "eval_history_batch"), run)
    assert got[0] is None and want[0] is None
    for position in range(1, 4):
        assert len(got[position]) == 2
        for g, w in zip(got[position], want[position]):
            assert g.dtype == np.float32 and g.shape == w.shape
            _assert_stats_close(g, w)
    # the averaging: the mean over the training run's train indices
    with open(os.path.join(run, "history.pickle"), "rb") as f:
        train_idx = np.asarray(pickle.load(f)["train_indices"][0])
    ordered = _dataset_order(_history(dirs["port"]["rec"]))
    np.testing.assert_allclose(got[3][1], ordered[2][1][train_idx].mean(0), rtol=1e-6)


def test_flow_off_matches_jax(ws):
    root, run, dirs, off_trainer = ws
    j_cols, j_rows = _columns(dirs["jax"]["off"])
    p_cols, p_rows = _columns(dirs["port"]["off"])
    assert p_cols == j_cols
    assert len(p_rows) == len(j_rows) == 1
    j_row, p_row = dict(zip(j_cols, j_rows[0])), dict(zip(p_cols, p_rows[0]))
    np.testing.assert_allclose(float(p_row["test_loss"]), float(j_row["test_loss"]), rtol=LOSS_RTOL)
    for k in ("test_acc", "test_acc_modal_0", "test_acc_modal_1"):
        assert np.isfinite(float(p_row[k])), k

    # per-view logits through each package's flow-off Trainer.predict
    _jax("eval", _flow_off(root, run, dirs["jax"]["rec"]))
    model, loaders = jax_build("MMTM_MVCNN", BATCH)
    test = loaders[2]
    maps = jax_get_rescale_weights(os.path.join(dirs["jax"]["rec"], "eval_history_batch"), run)
    jt = JaxTrainer(model, None, jax_init_state(model, test, BATCH, 777), average_squeezemaps=maps, mmtm_off=True,
                    verbose=False)
    jt.load_weights(os.path.join(run, CKPT))
    want = jt.predict(test)
    _port("eval", _data(root))
    got = off_trainer.predict(get_mvdcndata(batch_size=BATCH)[2])
    assert got["indices"].tolist() == want["indices"].tolist() == list(range(8))
    for g, w in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    # the flow really is cut: the same weights with the flow on give other logits
    off_trainer.mmtm_off = False
    try:
        flow_on = off_trainer.predict(get_mvdcndata(batch_size=BATCH)[2])
    finally:
        off_trainer.mmtm_off = True
    assert not np.allclose(flow_on["logits"][0], got["logits"][0], rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_ondevice_rescale_matches_pickle_path(ws, tmp_path):
    """``evalution_loop.ondevice_rescale`` writes the means the pickle path
    gives, without the per-sample payload; a means file made over another
    index set is passed over (tests/test_ondevice_rescale.py:74)."""
    root, run, dirs, _ = ws
    od = str(tmp_path / "od")
    _port("recording", _recording(root, run) + [
        "eval_.device='cpu'", "evalution_loop.ondevice_rescale=True",
        f"evalution_loop.ondevice_rescale_training_path='{run}'",
    ])
    eval_(od)
    od_dir = os.path.join(od, "eval_history_batch")
    with open(os.path.join(od_dir, RESCALE_MEANS_FILENAME), "rb") as f:
        blob = pickle.load(f)
    with open(os.path.join(run, "history.pickle"), "rb") as f:
        train_idx = np.asarray(pickle.load(f)["train_indices"][0])
    assert blob["count"] == len(train_idx) and np.array_equal(blob["selected"], train_idx)
    H = _history(od)
    assert "test_squeezedmaps_array_list" not in H
    assert len(H["test_indices"][0]) == 12

    rec_dir = os.path.join(dirs["port"]["rec"], "eval_history_batch")
    ref = get_rescale_weights(rec_dir, run)
    fast = get_rescale_weights(od_dir, run)
    for position in range(1, 4):
        for f, r in zip(fast[position], ref[position]):
            np.testing.assert_allclose(f, r, rtol=1e-5, atol=1e-6)
    with pytest.raises(Exception):  # another selection: no fast path, and no per-sample pickle
        get_rescale_weights(od_dir, run, validation=True)
    stale = dict(blob, selected=np.asarray([0], np.int64))
    stale_path = os.path.join(str(tmp_path), "rec")
    os.makedirs(stale_path)
    for name in ("history.pickle", "history.csv"):
        with open(os.path.join(rec_dir, name), "rb") as src, open(os.path.join(stale_path, name), "wb") as dst:
            dst.write(src.read())
    with open(os.path.join(stale_path, RESCALE_MEANS_FILENAME), "wb") as f:
        pickle.dump(stale, f)
    via_pickle = get_rescale_weights(stale_path, run)
    for position in range(1, 4):
        for v, r in zip(via_pickle[position], ref[position]):
            np.testing.assert_array_equal(v, r)


@pytest.mark.parametrize("case", ["unique", "duplicates"])
def test_accumulator_weights_rows_by_multiplicity(case):
    """Each row counts as often as its index is selected, padding never
    (tests/test_ondevice_rescale.py:146,190)."""
    rng = np.random.default_rng(1)
    B, C = 3, 4
    selected = [0, 2, 5] if case == "unique" else [1, 1, 2]
    acc = RescaleMeanAccumulator(selected, "cpu")
    steps = [([0, 1, 2], 3), ([5, 7], 2)] if case == "unique" else [([1, 2, 5], 3)]
    rows, weights = [], []
    for indices, size in steps:
        maps = rng.normal(size=(B, C)).astype(np.float32)
        member = acc.member_mask(indices, size, B)
        acc.consume([[torch.from_numpy(maps)]], member)
        rows.append(maps)
        weights.append(member)
    means, count = acc.means()
    rows, weights = np.concatenate(rows), np.concatenate(weights)
    if case == "unique":
        np.testing.assert_array_equal(weights, [1, 0, 1, 1, 0, 0])
    else:
        np.testing.assert_array_equal(weights, [2, 1, 0])
    assert count == len(selected)
    oracle = (rows * weights[:, None]).sum(0) / weights.sum()
    np.testing.assert_allclose(means[0][0], oracle, rtol=1e-6)


def test_train_time_recording_extras(tmp_path):
    """Training with the saving flags records per-batch, per-MMTM, per-view
    maps, the last batch trimmed to its real rows (tests/test_integration.py:203)."""
    root = make_synthetic_modelnet(str(tmp_path / "data"), n_train=12, n_test=4, num_views=2, image_size=IMG,
                                   nclasses=NC)
    _port("training_guided", _data(root) + [
        "train.device='cpu'", f"train.batch_size={BATCH}", "training_loop.n_epochs=2",
        "MMTM_MVCNN.saving_mmtm_scales=True", "MMTM_MVCNN.saving_mmtm_squeeze_array=True",
    ])
    train(str(tmp_path / "run"))
    with open(tmp_path / "run" / "history.pickle", "rb") as f:
        H = pickle.load(f)
    for key in ("train_mmtmscales_list", "train_squeezedmaps_array_list", "val_squeezedmaps_array_list",
                "test_mmtmscales_list"):
        assert key in H, key
    batches = H["train_mmtmscales_list"][0]
    assert len(batches) == 3  # 10 train samples in batches of 4
    assert [len(b) for b in batches] == [3, 3, 3] and all(len(m) == 2 for b in batches for m in b)
    assert batches[0][0][0].shape == (4, 128) and batches[0][2][1].shape == (4, 512)
    assert batches[-1][0][0].shape == (2, 128)
    scales = np.concatenate([b[1][0] for b in batches])
    assert ((scales > 0) & (scales < 1)).all()  # sigmoid gates


def test_eval_defaults_to_cuda(ws, tmp_path):
    """Without ``eval_.device`` the port asks for CUDA and raises where there
    is none, before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    root, run, _, _ = ws
    _port("recording", _recording(root, run))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_(str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")


def test_unknown_eval_callback_raises(ws, tmp_path):
    root, run, _, _ = ws
    _port("recording", _recording(root, run) + ["eval_.device='cpu'", "eval_.callbacks=['CompletedStoping']"])
    with pytest.raises(KeyError, match="CompletedStoping"):
        eval_(str(tmp_path / "out"))


def test_eval_cli_runs_both_passes(ws, tmp_path):
    """``python -m greedy_multimodal_learning_tpu_torch.eval``: the recording
    pass, then the flow-off pass on its maps."""
    root, run, dirs, _ = ws
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    rec, off = str(tmp_path / "rec"), str(tmp_path / "off")
    for out, config, bindings in (
        (rec, "recording", _recording(root, run)),
        (off, "eval", _flow_off(root, run, rec)),
    ):
        r = subprocess.run(
            [sys.executable, "-m", "greedy_multimodal_learning_tpu_torch.eval", out, CONFIGS[config],
             "#".join(bindings + ["eval_.device='cpu'"])],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
        )
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert list(_history(rec)) == list(_history(dirs["port"]["rec"]))
    cols, rows = _columns(off)
    assert cols == _columns(dirs["port"]["off"])[0] and len(rows) == 1
    assert os.path.exists(os.path.join(off, "operative_config.gin"))
