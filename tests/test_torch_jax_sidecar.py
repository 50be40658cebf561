"""The JAX package's ``.jax.pkl`` sidecar read by the port without jax
(``greedy_multimodal_learning_tpu_torch/engine/checkpoint.py``):

* ``load_training_state`` from a sidecar the JAX package's ``save_weights``
  wrote (momentum 0; momentum 0.9 with weight decay) restores what
  ``load_into_state(..., full_restore=True)`` restores: parameters,
  statistics, MMTM buffers, controller, step, both PRNG keys, learning
  rate and the momentum trace, exactly; one guided step from there, the
  port's flips drawn from the restored data key (the JAX package's),
  agrees with the JAX package's step within the bounds of
  ``tests/test_torch_train_step.py``;
* ``train`` with ``resume=True`` continues a two-epoch run of the JAX
  package to three epochs, keeping epochs 1-2 of ``history.csv`` verbatim,
  and its third epoch matches the JAX package's own resume (lr 1e-5, the
  flips drawn from the sidecar's data key whatever ``train.seed`` says: at
  the tests' lr the tiny network is chaotic);
* ``load_weights`` restores the MMTM buffers: a curated forward matches the
  JAX package's;
* the reader imports no jax, flax, optax nor the JAX package (a subprocess
  where importing them fails) and refuses every global that is neither
  numpy's array reconstruction nor an optax class;
* a checkpoint the JAX package wrote over a port run (a stale
  ``.torch.pt`` beside the new ``.jax.pkl``) raises in both loaders, and
  the port's next ``save_weights`` leaves one sidecar again."""

import csv
import functools
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu.data.transforms import preprocess as jax_preprocess
from greedy_multimodal_learning_tpu.engine import build_train_step, create_train_state
from greedy_multimodal_learning_tpu.engine import make_optimizer as jax_make_optimizer
from greedy_multimodal_learning_tpu.engine.bdr import GroupReducer as JaxGroupReducer
from greedy_multimodal_learning_tpu.engine.checkpoint import load_into_state
from greedy_multimodal_learning_tpu.engine.checkpoint import save_weights as jax_save_weights
from greedy_multimodal_learning_tpu.engine.controller import guided_update as jax_guided_update
from greedy_multimodal_learning_tpu.engine.train_state import set_learning_rate as jax_set_learning_rate
from greedy_multimodal_learning_tpu.entries import train as jax_train
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.data.transforms import preprocess
from greedy_multimodal_learning_tpu_torch.engine import Trainer, load_weights, make_optimizer, save_weights
from greedy_multimodal_learning_tpu_torch.engine import state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.engine.checkpoint import read_jax_sidecar
from greedy_multimodal_learning_tpu_torch.engine.controller import key_array
from greedy_multimodal_learning_tpu_torch.entries import train
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs", "training_guided.gin")
B, V, IMG, NC = 4, 2, 32, 4
EPSILON, WINDOW = 1e-3, 2
FIELDS = ("M_main", "M_bypass", "curation_mode", "caring_modality", "curation_step", "d_BDR")
SAVED_LR = 0.03  # the learning rate the sidecar holds; the port's optimizer starts at another
# tests/test_torch_train_step.py's bounds: forward quantities, each
# parameter's update in L2, and the BDR ratios
FWD_TOL = (1e-4, 1e-5)
UPDATE_TOL = 5e-2
BDR_RTOL = 2e-2
F32_TOL = (1e-4, 1e-5)  # (rtol, atol) of the resumed epoch's metrics
# the curated forward's logits: rtol, and atol as a fraction of the largest
# |logit| (two steps at lr 0.05 leave the statistics far from converged and
# logits of order 1e3, whose f32 rounding then reaches the small ones)
LOGIT_TOL = (1e-4, 1e-5)
CLOCK_COLUMNS = ("time", "epoch_begin_time", "train_samples_per_sec")


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


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (B, V, IMG, IMG, 3), dtype=np.uint8),
        "labels": rng.integers(0, NC, B).astype(np.int32),
        "mask": np.array([1, 1, 1, 0], np.float32),
    }


def _jax_step(momentum, wd):
    model = JaxMMTMMVCNN(nclasses=NC)
    opt = jax_make_optimizer(lr=0.05, momentum=momentum, weight_decay=wd)
    state = create_train_state(model, opt, jax.random.PRNGKey(3), jnp.zeros((B, V, IMG, IMG, 3)))
    update = functools.partial(jax_guided_update, epsilon=EPSILON, curation_windowsize=WINDOW)
    return model, opt, state, build_train_step(model, opt, JaxGroupReducer(state.params), update, donate=False)


def _jax_flips(rng, step, shape):
    return np.array(jax.random.bernoulli(jax.random.fold_in(jnp.asarray(rng), step), 0.5, shape))


@pytest.fixture(scope="module", params=[(0.0, 0.0), (0.9, 5e-4)], ids=["momentum0", "momentum0.9_wd"])
def saved(request, tmp_path_factory):
    """A JAX state after two guided steps (so the trace, the controller and
    the MMTM buffers are non-zero) with its learning rate then set to
    ``SAVED_LR``, written by the JAX package's ``save_weights``; and the
    compiled step."""
    momentum, wd = request.param
    model, opt, state, step = _jax_step(momentum, wd)
    for t in range(2):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in _batch(t).items()}, jnp.asarray(True))
    state = jax_set_learning_rate(state, SAVED_LR)
    path = str(tmp_path_factory.mktemp("sidecar") / "model_last_epoch.pt")
    jax_save_weights(state, path)
    fresh = create_train_state(model, opt, jax.random.PRNGKey(9), jnp.zeros((B, V, IMG, IMG, 3)))
    yield {"momentum": momentum, "wd": wd, "path": path, "step": step, "model": model,
           "restored": load_into_state(fresh, path, full_restore=True)}
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def _port_trainer(momentum, wd, lr=0.5):
    model = init_model(MMTMMVCNN(nclasses=NC), 11, "cpu")
    return Trainer(model, make_optimizer(model.parameters(), lr=lr, momentum=momentum, weight_decay=wd),
                   controller_kind="guided", controller_config={"epsilon": EPSILON, "curation_windowsize": WINDOW},
                   device="cpu")


def test_restore_matches_load_into_state(saved):
    want = saved["restored"]
    trainer = _port_trainer(saved["momentum"], saved["wd"])
    trainer.restore(saved["path"])
    got = trainer.model.state_dict()
    for key, value in state_dict_from_jax(want.params, want.batch_stats, want.mmtm).items():
        assert torch.equal(got[key], value), key
    for f in FIELDS:
        want_f = np.asarray(getattr(want.controller, f))
        got_f = getattr(trainer.ctrl, f).numpy()
        assert got_f.dtype == want_f.dtype and np.array_equal(got_f, want_f), f
    assert trainer.step == int(want.step) == 2
    # both PRNG keys are kept (the controller's and the data key)
    np.testing.assert_array_equal(key_array(trainer.ctrl.rng), np.asarray(want.controller.rng))
    np.testing.assert_array_equal(trainer.data_key, np.asarray(want.rng))
    assert trainer.get_lr() == float(np.asarray(want.opt_state.hyperparams["learning_rate"])) == np.float32(SAVED_LR)
    traces = [s for s in want.opt_state.inner_state if type(s).__name__ == "TraceState"]
    state = trainer.optimizer.state
    if saved["momentum"]:
        buffers = state_dict_from_jax(traces[0].trace, {})
        params = dict(trainer.model.named_parameters())
        assert set(buffers) == set(params)
        for name, p in params.items():
            buf = state[p]["momentum_buffer"]
            assert torch.equal(buf, buffers[name]) and buf.stride() == p.stride(), name
    else:
        assert not traces and not any(state.values())


def test_one_step_after_restore_matches_jax(saved):
    """One guided step from the restored states, the port drawing its flips
    from the restored data key (the JAX package's flips), within
    tests/test_torch_train_step.py's bounds."""
    state = saved["restored"]
    trainer = _port_trainer(saved["momentum"], saved["wd"])
    trainer.restore(saved["path"])
    batch = _batch(7)
    flips = trainer.train_flips(B, V).numpy()
    np.testing.assert_array_equal(flips, _jax_flips(state.rng, int(state.step), (B, V)))
    before = state_dict_from_jax(state.params, state.batch_stats, state.mmtm)
    state, j_out = saved["step"](state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(True))
    t_out = trainer.train_batch({k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(flips),
                                torch.tensor(True))
    for key in ("loss", "acc", "acc_modal"):
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), *FWD_TOL, err_msg=key)
    for f in FIELDS:
        got, want = getattr(trainer.ctrl, f).numpy(), np.asarray(getattr(state.controller, f))
        if f in ("M_main", "M_bypass", "d_BDR"):
            np.testing.assert_allclose(got, want, rtol=BDR_RTOL, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    params = {n for n, _ in trainer.model.named_parameters()}
    got = trainer.model.state_dict()
    for key, want in state_dict_from_jax(state.params, state.batch_stats, state.mmtm).items():
        if key in params:
            err = float((got[key] - want).norm())
            assert err <= UPDATE_TOL * float((want - before[key]).norm()) + 1e-7, (key, err)
        else:
            np.testing.assert_allclose(got[key].numpy(), want.numpy(), *FWD_TOL, err_msg=key)


def test_momentum_disagreeing_with_the_run_raises(saved):
    trainer = _port_trainer(0.0 if saved["momentum"] else 0.9, 0.0)
    with pytest.raises(ValueError, match="momentum"):
        trainer.restore(saved["path"])


def test_load_weights_restores_the_mmtm_buffers(saved):
    """A curated forward depends on the MMTM running averages: the port's
    model after ``load_weights`` gives the JAX package's logits."""
    state = saved["restored"]
    port = init_model(MMTMMVCNN(nclasses=NC), 11, "cpu")
    load_weights(port, saved["path"])
    assert port.mmtm3.step.item() == float(np.asarray(state.mmtm["mmtm3"]["step"])) > 0
    batch = _batch(8)
    for caring in (0, 1):
        (_, j_logits, _, _), _ = saved["model"].apply(
            {"params": state.params, "batch_stats": state.batch_stats, "mmtm": state.mmtm},
            jax_preprocess(jnp.asarray(batch["images"]), train=False), jnp.asarray(True), jnp.asarray(caring),
            train=False, valid_mask=jnp.asarray(batch["mask"]), mutable=["mmtm"])
        with torch.no_grad():
            _, t_logits, _, _ = port(preprocess(torch.from_numpy(batch["images"]), train=False), torch.tensor(True),
                                     torch.tensor(caring), valid_mask=torch.from_numpy(batch["mask"]), mmtm_state={})
        for t, j in zip(t_logits, j_logits):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=LOGIT_TOL[0], atol=LOGIT_TOL[1] * np.abs(j).max())


def test_two_sidecars_raise_in_both_loaders(saved, tmp_path):
    """The JAX package writing over a port checkpoint leaves the port's
    ``.torch.pt`` stale beside its ``.jax.pkl``: neither loader guesses."""
    path = str(tmp_path / "model_last_epoch.pt")
    trainer = _port_trainer(saved["momentum"], saved["wd"])
    save_weights(trainer.model, path, optimizer=trainer.optimizer, controller=trainer.ctrl.as_dict(), step=5)
    for ext in ("", ".jax.pkl"):
        shutil.copyfile(saved["path"] + ext, path + ext)
    with pytest.raises(ValueError, match="two sidecars"):
        load_weights(init_model(MMTMMVCNN(nclasses=NC), 11, "cpu"), path)
    with pytest.raises(ValueError, match="two sidecars"):
        _port_trainer(saved["momentum"], saved["wd"]).restore(path)
    save_weights(trainer.model, path, optimizer=trainer.optimizer, controller=trainer.ctrl.as_dict(), step=5)
    assert not os.path.exists(path + ".jax.pkl")
    again = _port_trainer(saved["momentum"], saved["wd"])
    again.restore(path)
    assert again.step == 5


_NO_JAX = """
import json, sys
for name in ("jax", "jaxlib", "flax", "optax", "greedy_multimodal_learning_tpu"):
    sys.modules[name] = None
from greedy_multimodal_learning_tpu_torch.engine.checkpoint import read_jax_sidecar
from greedy_multimodal_learning_tpu_torch.engine.controller import key_array
side = read_jax_sidecar(sys.argv[1])
print(json.dumps({"keys": sorted(side), "opt_state": type(side["opt_state"]).__name__,
                  "inner": [type(s).__name__ for s in side["opt_state"].inner_state], "step": int(side["step"]),
                  "lr": float(side["opt_state"].hyperparams["learning_rate"])}))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax") and sys.modules[m])
sys.exit(1 if bad else 0)
"""


def test_reading_the_sidecar_needs_no_jax(saved):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _NO_JAX, saved["path"] + ".jax.pkl"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    got = json.loads(r.stdout)
    assert got["keys"] == ["batch_stats", "controller", "mmtm", "opt_hyperparams", "opt_state", "params", "rng", "step"]
    assert got["opt_state"] == "InjectStatefulHyperparamsState" and got["step"] == 2
    assert got["lr"] == np.float32(SAVED_LR)
    assert ("TraceState" in got["inner"]) == bool(saved["momentum"])


class _Call:
    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("fn", [os.system, eval, subprocess.Popen, shutil.rmtree, torch.load],
                         ids=["os.system", "builtins.eval", "subprocess.Popen", "shutil.rmtree", "torch.load"])
def test_a_foreign_global_is_refused(tmp_path, fn):
    marker = tmp_path / "ran"
    path = tmp_path / "evil.jax.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": _Call(fn, f"touch {marker}")}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing the global"):
        read_jax_sidecar(str(path))
    assert not marker.exists()


# ---- resume of a JAX run -------------------------------------------------------------


def _bindings(root, n_epochs, resume=False):
    return [
        f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", f"MMTM_MVCNN.nclasses={NC}",
        f"train.batch_size={B}", "train.lr=1e-5", "train.momentum=0.9", f"training_loop.n_epochs={n_epochs}",
        f"training_loop.resume={resume}",
    ]


def _rows(save):
    with open(os.path.join(save, "history.csv")) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A two-epoch run of the JAX package (guided, momentum 0.9, lr 1e-5),
    then resumed to three epochs by the JAX package and, from a copy, by the
    port, whose flips come from the data key the sidecar holds."""
    base = tmp_path_factory.mktemp("resume")
    root = make_synthetic_modelnet(str(base / "data"), n_train=8, n_test=4, num_views=2, image_size=IMG, nclasses=NC)
    run = str(base / "jax")
    jax_cfg.parse_config_files_and_bindings([CONFIG], "\n".join(_bindings(root, 3)))
    jax_train(run)
    first = _rows(run)
    port_run = str(base / "port")
    shutil.copytree(run, port_run)
    jax_cfg.clear_config()
    jax_cfg.parse_config_files_and_bindings([CONFIG], "\n".join(_bindings(root, 4, True)))
    jax_train(run)
    jax_cfg.clear_config()

    # another seed: the keys come from the sidecar, not from train.seed
    port_cfg.parse_config_files_and_bindings(
        [CONFIG], "\n".join(_bindings(root, 4, True) + ["train.device='cpu'", "train.seed=5"]))
    trainer = train(port_run)
    yield first, _rows(run), _rows(port_run), trainer, port_run
    shutil.rmtree(base, ignore_errors=True)


def test_resume_continues_a_jax_run(resumed):
    first, jax_rows, port_rows, trainer, port_run = resumed
    assert port_rows[0] == jax_rows[0] == first[0]
    assert port_rows[:3] == first  # epochs 1-2 verbatim
    assert [r[port_rows[0].index("epoch")] for r in port_rows[1:]] == ["1", "2", "3"]
    assert trainer.step == 6  # 7 train samples (one in val) in batches of 4, three epochs
    # the port's checkpoints replace the JAX package's: no stale sidecar stays beside them
    assert not os.path.exists(os.path.join(port_run, "model_last_epoch.pt.jax.pkl"))
    for name, got, want in zip(port_rows[0], port_rows[3], jax_rows[3]):
        if name not in CLOCK_COLUMNS:
            np.testing.assert_allclose(float(got), float(want), *F32_TOL, err_msg=name)
