"""The training slice end to end on the CPU: the port's ``train`` entry with
``configs/training_guided.gin`` on a tiny synthetic split writes the JAX
package's artifacts (``history.csv`` with the columns the JAX package's own
run writes, ``history.pickle``, ``model_best_val.pt``,
``model_last_epoch.pt``), and the port's ``model_best_val.pt`` loads in the
JAX package and gives the port's eval logits."""

import csv
import os
import pickle
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu.engine import create_train_state
from greedy_multimodal_learning_tpu.engine.checkpoint import load_pretrained
from greedy_multimodal_learning_tpu.entries import train as jax_train
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu.utils.torch_compat import merge_loaded_params
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.engine import load_weights
from greedy_multimodal_learning_tpu_torch.entries import construct_callbacks, eval_, train
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN
from greedy_multimodal_learning_tpu_torch.parallel import tensor as tensor_parallel

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs", "training_guided.gin")
IMG, NC, BATCH = 32, 4, 4
RTOL, ATOL = 5e-3, 5e-4  # the logits tolerance of tests/test_torch_parity.py:163


@pytest.fixture(autouse=True)
def _clean_port_config():
    port_cfg.clear_config()
    yield
    port_cfg.clear_config()


def _bindings(root):
    return [
        f"get_mvdcndata.root_dir='{root}'",
        "get_mvdcndata.specific_views=[0, 1]",
        f"MMTM_MVCNN.nclasses={NC}",
        f"train.batch_size={BATCH}",
        "training_loop.n_epochs=3",  # two epochs run (quirk #3)
    ]


def _columns(path):
    with open(os.path.join(path, "history.csv")) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("train")
    root = make_synthetic_modelnet(str(base / "data"), n_train=10, n_test=6, num_views=2, image_size=IMG, nclasses=NC)
    jax_cfg.clear_config()
    jax_cfg.parse_config_files_and_bindings([CONFIG], "\n".join(_bindings(root)))
    jax_train(str(base / "jax"))
    jax_cfg.clear_config()
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings(
        [CONFIG], "\n".join(_bindings(root) + ["train.device='cpu'", "MMTM_mitigate.use_pallas=True"])
    )
    trainer = train(str(base / "port"))
    port_cfg.clear_config()
    return root, str(base / "jax"), str(base / "port"), trainer


def test_writes_the_jax_packages_artifacts(runs):
    _, jax_dir, port_dir, trainer = runs
    j_cols, j_rows = _columns(jax_dir)
    p_cols, p_rows = _columns(port_dir)
    assert p_cols == j_cols
    assert len(p_rows) == len(j_rows) == 2
    assert all(np.isfinite(float(v)) for r in p_rows for v in r)
    with open(os.path.join(jax_dir, "history.pickle"), "rb") as f:
        j_hist = pickle.load(f)
    with open(os.path.join(port_dir, "history.pickle"), "rb") as f:
        p_hist = pickle.load(f)
    assert list(p_hist) == list(j_hist)
    assert sorted(np.concatenate(p_hist["train_indices"]).tolist()) == sorted(
        np.concatenate(j_hist["train_indices"]).tolist())
    for name in ("model_best_val.pt", "model_last_epoch.pt"):
        assert os.path.exists(os.path.join(port_dir, name))
        side = torch.load(os.path.join(port_dir, name + ".torch.pt"), weights_only=False)
        assert side["step"] in (2, 4) and set(side["controller"]) >= {"M_main", "curation_mode"}
        assert any(k.endswith("running_avg_visual") for k in side["mmtm"])
    assert trainer.step == 4  # 8 train samples in batches of 4, two epochs
    last = torch.load(os.path.join(port_dir, "model_last_epoch.pt.torch.pt"), weights_only=False)
    assert last["step"] == 4


def test_port_checkpoint_loads_in_the_jax_package(runs):
    root, _, port_dir, _ = runs
    path = os.path.join(port_dir, "model_best_val.pt")
    params, batch_stats, extras = load_pretrained(path)
    assert extras is None  # no .jax.pkl sidecar: the JAX package reads the .pt itself
    x = np.random.default_rng(0).normal(size=(3, 2, IMG, IMG, 3)).astype(np.float32)
    mask = np.array([1, 1, 0], np.float32)
    jmodel = JaxMMTMMVCNN(nclasses=NC)
    state = create_train_state(jmodel, None, jax.random.PRNGKey(5), jnp.asarray(x))
    state = state.replace(params=merge_loaded_params(state.params, params),
                          batch_stats=merge_loaded_params(state.batch_stats, batch_stats))
    (_, j_logits, _, _), _ = jmodel.apply(
        {"params": state.params, "batch_stats": state.batch_stats, "mmtm": state.mmtm},
        jnp.asarray(x), train=False, valid_mask=jnp.asarray(mask), mutable=["mmtm"],
    )
    port = init_model(MMTMMVCNN(nclasses=NC), 123, "cpu")
    load_weights(port, path)
    with torch.no_grad():
        _, t_logits, _, _ = port(torch.from_numpy(x), valid_mask=torch.from_numpy(mask), mmtm_state={})
    for t, j in zip(t_logits, j_logits):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_callbacks_by_name():
    assert [type(c).__name__ for c in construct_callbacks(["CompletedStopping", "Bias_Mitigation_Strong"])] == [
        "CompletedStopping", "Bias_Mitigation_Strong"]
    with pytest.raises(KeyError, match="Bias_Mitigation_Strongg"):
        construct_callbacks(["Bias_Mitigation_Strongg"])
    controllers = ["Bias_Mitigation_Random", "Bias_Mitigation_Weakest", "Bias_Mitigation_AdaptiveWeakest"]
    built = construct_callbacks(controllers)
    assert [type(c).__name__ for c in built] == controllers
    assert [c.controller_kind for c in built] == ["random", "weakest", "adaptive_weakest"]


@pytest.mark.parametrize("binding", ["training_loop.model_parallel=2", "evalution_loop.model_parallel=2"])
def test_model_parallel_without_data_parallel_is_ignored(tmp_path, binding):
    """Without ``data_parallel`` ``model_parallel`` is ignored, as the JAX
    package builds its mesh only under ``data_parallel``: the entry whose
    loop takes it (``evalution_loop``'s in ``eval_``, on a trained run's
    checkpoint) runs the plain path, with no world and nothing sharded."""
    root = make_synthetic_modelnet(str(tmp_path / "data"), n_train=5, n_test=2, num_views=2, image_size=IMG, nclasses=NC)
    common = _bindings(root) + ["train.device='cpu'", "eval_.device='cpu'"]
    port_cfg.parse_config_files_and_bindings(
        [CONFIG], "\n".join(common + ([binding] if binding.startswith("training_loop") else [])))
    trainer = train(str(tmp_path / "run"))
    if binding.startswith("evalution_loop"):
        port_cfg.clear_config()
        port_cfg.parse_config_files_and_bindings([CONFIG], "\n".join(common + [
            binding, f"eval_.pretrained_weights_path='{tmp_path / 'run' / 'model_last_epoch.pt'}'"]))
        trainer = eval_(str(tmp_path / "eval"))
        assert (tmp_path / "eval" / "eval_history_batch" / "history.csv").exists()
    assert trainer.world is None and not tensor_parallel.is_sharded(trainer.model)


@pytest.mark.parametrize("binding", [
    "training_loop.fold_bn_eval=True",
    "MMTM_MVCNN.stem_s2d=True",
    "MMTM_MVCNN.remat=True",
    "training_loop.data_parallel=True",  # over a one-rank group of its own: no process group here
    "training_loop.orbax_dir='snapshots'",  # one asynchronous snapshot, under save_path
])
def test_ported_loop_options_train(tmp_path, binding):
    """Options that raised before they were ported: each trains an epoch on
    the CPU with finite losses and writes every artifact."""
    root = make_synthetic_modelnet(str(tmp_path / "data"), n_train=5, n_test=2, num_views=2, image_size=IMG, nclasses=NC)
    port_cfg.parse_config_files_and_bindings(
        [CONFIG], "\n".join(_bindings(root) + ["train.device='cpu'", "training_loop.n_epochs=2", binding])
    )
    save = tmp_path / "run"
    trainer = train(str(save))
    _, rows = _columns(str(save))
    assert len(rows) == 1 and trainer.step >= 1
    with open(save / "history.csv") as f:
        row = next(csv.DictReader(f))
    assert all(np.isfinite(float(row[k])) for k in ("loss", "val_loss", "test_loss"))
    for name in ("history.csv", "history.pickle", "model_best_val.pt", "model_last_epoch.pt",
                 "model_best_val.pt.torch.pt", "model_last_epoch.pt.torch.pt"):
        assert (save / name).exists(), name
    if "orbax_dir" in binding:
        assert sorted(os.listdir(save / "snapshots")) == ["1"] and (save / "snapshots" / "1" / ".metadata").exists()
    shutil.rmtree(save)  # ~190 MB of full-width checkpoints
