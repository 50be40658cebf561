"""BatchNorm folding in the port (``greedy_multimodal_learning_tpu_torch/engine/fold_bn.py``)
against the JAX package's ``engine/fold_bn.py``, for both model families:

* ``fold_batchnorm`` on the same weights as the JAX function, within
  ``FOLD_ULPS`` f32 ulps of the largest term each tensor's arithmetic
  rounds;
* folded eval logits against unfolded ones (rtol 2e-4, atol 2e-4, as
  ``tests/test_fold_bn.py:51``), and the inputs left as they were;
* ``Trainer(fold_bn_eval=True)``: the same val and test losses as an
  unfolded run (rtol 1e-4, atol 1e-4) and bit-identical training;
* ``predict_`` with ``fold_bn=True`` against the JAX package's."""

import csv
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu.engine.fold_bn import fold_batchnorm as jax_fold_batchnorm
from greedy_multimodal_learning_tpu.models import MMTM3DCNN as JaxMMTM3DCNN
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.data import BatchPipeline, MultiviewModelNet
from greedy_multimodal_learning_tpu_torch.engine import Trainer, fold_batchnorm, make_optimizer, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.engine.callbacks import LambdaCallback
from greedy_multimodal_learning_tpu_torch.models import MMTM3DCNN, MMTMMVCNN
from greedy_multimodal_learning_tpu_torch.predict import predict_

REPO = os.path.join(os.path.dirname(__file__), "..")
NC = 5
FOLD_TOL = (2e-4, 2e-4)  # (rtol, atol): tests/test_fold_bn.py:51
LOSS_TOL = (1e-4, 1e-4)  # (rtol, atol): tests/test_fold_bn.py:134
CONF_ATOL = 2e-6  # predictions.csv writes confidences with 6 decimals
# torch's and XLA's f32 rsqrt are each within 1 ulp of the exact value but up
# to 2 ulps apart from each other, so the scale g = weight * rsqrt(var + eps)
# differs by up to 2 ulps, and w * g and bias - mean * g by up to 3 ulps of
# their largest term once rounded
FOLD_ULPS = 3


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


def _perturbed(tree, rng, path=()):
    """A flax tree with seeded non-trivial BatchNorm statistics and affine
    (means ~N(0, 0.2), variances and scales in [0.5, 1.5], biases ~N(0, 0.1))."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _perturbed(v, rng, path + (k,)) for k, v in tree.items()}
    leaf = np.asarray(tree)
    name = path[-1]
    bn = any("bn" in p for p in path[:-1])
    if name == "mean":
        return rng.normal(0, 0.2, leaf.shape).astype(np.float32)
    if name == "var" or (bn and name == "scale"):
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    if bn and name == "bias":
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    return leaf


FAMILIES = {
    "2d": (lambda: JaxMMTMMVCNN(nclasses=NC), lambda: MMTMMVCNN(nclasses=NC), (2, 2, 32, 32, 3)),
    "3d": (lambda: JaxMMTM3DCNN(nclasses=NC, num_towers=3, width_multiplier=0.25),
           lambda: MMTM3DCNN(nclasses=NC, width_multiplier=0.25), (2, 3, 4, 16, 16, 3)),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(JAX params, batch_stats), the JAX fold of them, the port's model on
    the same weights, and an input."""
    make_jax, make_port, shape = FAMILIES[request.param]
    variables = make_jax().init(jax.random.PRNGKey(0), jnp.zeros(shape), train=False)
    rng = np.random.default_rng(1)
    params, stats = _perturbed(variables["params"], rng), _perturbed(variables["batch_stats"], rng)
    folded = jax_fold_batchnorm(params, stats)
    port = make_port()
    port = port.to(memory_format=port.memory_format).eval()
    port.load_state_dict(state_dict_from_jax(params, stats), strict=False)
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, shape).astype(np.float32))
    return request.param, (params, stats), folded, port, x


def _largest_terms(state, eps=1e-5):
    """For each folded BatchNorm bias, the largest |term| of bias - mean * g."""
    out = {}
    for key, mean in state.items():
        if key.endswith(".running_mean"):
            scope = key[: -len(".running_mean")]
            g = state[f"{scope}.weight"].double() / torch.sqrt(state[f"{scope}.running_var"].double() + eps)
            out[f"{scope}.bias"] = max(float(state[f"{scope}.bias"].abs().max()), float((mean.double() * g).abs().max()))
    return out


def test_fold_matches_the_jax_function(family):
    _, (params, stats), (jax_p, jax_s), port, _ = family
    state = port.state_dict()
    got = fold_batchnorm(state)
    want = state_dict_from_jax(jax_p, jax_s)
    changed = [k for k in want if not torch.equal(want[k], state_dict_from_jax(params, stats)[k])]
    assert any(k.endswith("conv1.weight") for k in changed) and any("downsample.0" in k for k in changed)
    terms = _largest_terms(state)
    for key, value in want.items():
        g, w = got[key].numpy(), value.numpy()
        ulp = np.spacing(np.float32(max(np.abs(w).max(), terms.get(key, 0.0))))
        assert np.abs(g - w).max() <= FOLD_ULPS * ulp, (key, float(np.abs(g - w).max() / ulp))


def test_folded_eval_logits_match_and_inputs_stay(family):
    name, _, _, port, x = family
    state = port.state_dict()
    before = {k: v.clone() for k, v in state.items()}
    folded = fold_batchnorm(state)
    assert all(torch.equal(state[k], before[k]) for k in before)
    assert all(folded[k] is state[k] for k in state if ".mmtm" in f".{k}" or k.endswith("num_batches_tracked"))
    with torch.no_grad():
        _, want, _, _ = port(x, mmtm_state={})
        _, got, _, _ = torch.func.functional_call(port, folded, (x,), {"mmtm_state": {}})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), *FOLD_TOL, err_msg=name)
    bn = port.net_view_0.layer2[0].downsample[1]
    assert folded["net_view_0.layer2.0.downsample.1.weight"].eq(1).all()
    assert not torch.equal(folded["net_view_0.layer2.0.downsample.0.weight"], bn.weight)


def _loaders(tmp_path, batch=4):
    root = make_synthetic_modelnet(str(tmp_path), n_train=12, n_test=8, num_views=2, image_size=32, nclasses=NC)
    train_ds = MultiviewModelNet(root, "train", specific_view=[0, 1])
    test_ds = MultiviewModelNet(root, "test", specific_view=[0, 1])
    return (BatchPipeline(train_ds, range(12), batch, shuffle=True, seed=5),
            BatchPipeline(test_ds, range(8), batch, shuffle=False))


def test_trainer_fold_bn_eval_matches_unfolded(tmp_path):
    """Two epochs with ``fold_bn_eval`` on and off: the train losses, the
    final parameters and BatchNorm statistics are bit-identical (training
    never sees the folded tensors), val and test losses agree within
    ``LOSS_TOL`` (``tests/test_fold_bn.py:108-137``), and so do the MMTM
    running averages, which the eval passes update from their gates."""
    train, test = _loaders(tmp_path)
    logs, weights = {}, {}
    for fold in (False, True):
        model = init_model(MMTMMVCNN(nclasses=NC), 0, "cpu")
        trainer = Trainer(model, make_optimizer(model.parameters(), lr=0.05), device="cpu", verbose=False,
                          fold_bn_eval=fold)
        logs[fold] = []
        cap = LambdaCallback(on_epoch_end=lambda epoch, log, out=logs[fold]: out.append(dict(log)))
        trainer.train_loop(train, valid_generator=test, test_generator=test, epochs=2, steps_per_epoch=len(train),
                           validation_steps=len(test), test_steps=len(test), callbacks=[cap])
        weights[fold] = model.state_dict()
    for a, b in zip(logs[False], logs[True]):
        assert a["loss"] == b["loss"] and a["acc"] == b["acc"]
        for key in ("val_loss", "test_loss"):
            np.testing.assert_allclose(b[key], a[key], *LOSS_TOL, err_msg=key)
        assert a["val_acc"] == b["val_acc"] and a["test_acc"] == b["test_acc"]
    for key, value in weights[False].items():
        if key.startswith("mmtm"):
            np.testing.assert_allclose(weights[True][key].numpy(), value.numpy(), *LOSS_TOL, err_msg=key)
        else:
            assert torch.equal(weights[True][key], value), key


@pytest.fixture(scope="module")
def seeded_run(tmp_path_factory):
    """A test split and a checkpoint in the JAX package's ``.pt`` layout with
    perturbed BatchNorm statistics."""
    base = tmp_path_factory.mktemp("predict")
    root = make_synthetic_modelnet(str(base / "data"), n_train=4, n_test=6, num_views=2, image_size=32, nclasses=NC)
    model = init_model(MMTMMVCNN(nclasses=NC), 3, "cpu")
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    sd = {k: v.contiguous() for k, v in model.state_dict().items()
          if not (k.endswith("num_batches_tracked") or ".running_avg_" in k or k.endswith(".step"))}
    path = str(base / "seeded.pt")
    torch.save({"model": sd, "optimizer": {}}, path)
    yield root, path, base
    shutil.rmtree(base, ignore_errors=True)


def _bindings(root, path, scope, *extra):
    return [f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", f"MMTM_MVCNN.nclasses={NC}",
            f"{scope}.pretrained_weights_path='{path}'", f"{scope}.batch_size=4", *extra]


def _predictions(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_predict_fold_bn_matches_jax(seeded_run):
    from predict import predict_ as jax_predict_

    root, path, base = seeded_run
    config = [os.path.join(REPO, "configs", "training_guided.gin")]
    jax_cfg.parse_config_files_and_bindings(config, "\n".join(_bindings(root, path, "predict_", "predict_.fold_bn=True")))
    jax_rows = _predictions(jax_predict_(str(base / "jax")))
    outs = {}
    for fold in (False, True):
        port_cfg.clear_config()
        port_cfg.parse_config_files_and_bindings(config, "\n".join(_bindings(
            root, path, "predict_", "predict_.device='cpu'", f"predict_.fold_bn={fold}")))
        csv_path, outs[fold] = predict_(str(base / f"port_{fold}"))
    port_rows = _predictions(csv_path)
    assert [r["index"] for r in port_rows] == [r["index"] for r in jax_rows] and len(port_rows) == 6
    for p, j in zip(port_rows, jax_rows):
        assert p["predicted_class"] == j["predicted_class"]
        assert abs(float(p["confidence"]) - float(j["confidence"])) <= CONF_ATOL + 1e-4 * float(j["confidence"])
    for g, w in zip(outs[True]["logits"], outs[False]["logits"]):
        np.testing.assert_allclose(g, w, *FOLD_TOL)
