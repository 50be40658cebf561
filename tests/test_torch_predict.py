"""The serving slice end to end: the JAX package's ``predict.py`` and the
port's ``predict_`` on the same synthetic split and checkpoint, under
``configs/training_guided.gin`` with ``MMTM_mitigate.use_pallas=True``, write
the same predictions.csv."""

import csv
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu.engine import create_train_state
from greedy_multimodal_learning_tpu.engine.checkpoint import save_weights
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.predict import predict_

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs", "training_guided.gin")
IMG, NCLASSES, N_TEST, BATCH = 32, 4, 6, 4  # 6 samples in batches of 4: one padded batch


@pytest.fixture(autouse=True)
def _clean_port_config():
    port_cfg.clear_config()
    yield
    port_cfg.clear_config()


@pytest.fixture(scope="module")
def split_and_checkpoint(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_modelnet(root, n_train=4, n_test=N_TEST, num_views=2, image_size=IMG, nclasses=NCLASSES)
    model = JaxMMTMMVCNN(nclasses=NCLASSES, use_pallas=True)
    sample = jnp.zeros((BATCH, 2, IMG, IMG, 3), jnp.float32)
    state = create_train_state(model, None, jax.random.PRNGKey(0), sample)
    ckpt = os.path.join(root, "model.pt")
    save_weights(state, ckpt)
    return root, ckpt


def _bindings(root, ckpt):
    return "\n".join([
        "MMTM_mitigate.use_pallas=True",
        f"MMTM_MVCNN.nclasses={NCLASSES}",
        f"predict_.batch_size={BATCH}",
        f"predict_.pretrained_weights_path='{ckpt}'",
        f"get_mvdcndata.root_dir='{root}'",
        "get_mvdcndata.specific_views=[0, 1]",
    ])


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _jax_predict():
    spec = importlib.util.spec_from_file_location("_jax_predict_entry", os.path.join(REPO, "predict.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.predict_


def test_port_predict_matches_jax_predict(split_and_checkpoint, tmp_path):
    root, ckpt = split_and_checkpoint
    jax_cfg.parse_config_files_and_bindings([CONFIG], _bindings(root, ckpt))
    jax_csv = _jax_predict()(str(tmp_path / "jax"))

    port_cfg.parse_config_files_and_bindings([CONFIG], _bindings(root, ckpt) + "\npredict_.device='cpu'")
    port_csv, out = predict_(str(tmp_path / "port"))

    jax_rows, port_rows = _read(jax_csv), _read(port_csv)
    assert len(port_rows) == N_TEST
    assert list(port_rows[0]) == ["index", "model", "true_class", "predicted_class", "confidence"]
    for col in ("index", "model", "true_class", "predicted_class"):
        assert [r[col] for r in port_rows] == [r[col] for r in jax_rows], col
    np.testing.assert_allclose(
        [float(r["confidence"]) for r in port_rows], [float(r["confidence"]) for r in jax_rows], atol=1e-4
    )
    assert out["indices"].tolist() == list(range(N_TEST))


def test_port_predict_defaults_to_cuda(split_and_checkpoint, tmp_path):
    """Without ``predict_.device`` the port asks for CUDA and raises where
    there is none, rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    root, ckpt = split_and_checkpoint
    port_cfg.parse_config_files_and_bindings([CONFIG], _bindings(root, ckpt))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_(str(tmp_path / "port"))
    assert not os.path.exists(tmp_path / "port" / "predictions.csv")
