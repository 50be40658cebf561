"""The random, weakest and adaptive-weakest controllers of the port against
the JAX package's (``engine/controller.py``, ``engine/callbacks.py``), on
the CPU:

* the three update functions over 40 steps from the same state and the same
  BDR sums, with host-set targets, gates opening and closing, the lock on
  and off, and (random) the port splitting the key it carries as the JAX
  package does: the flags, target, counters and key exactly, the BDR sums
  and d_BDR to float32 rounding;
* the port's random draws: the JAX package's key chain from the seed,
  uniform, and locked before ``starting_epoch``;
* the callbacks' designation, gap, monitor fallback, ``__init__`` errors
  and resume rule (``tests/test_engine.py:237-306`` for the JAX package);
* the trainer's hooks: the target written on the device, eval passes with
  curation off under the weakest controllers only, the empty-group check;
* ``configs/training_weakest.gin`` through both packages' ``train`` entries
  from the seed alone (the port draws the JAX package's initial weights and
  flips): the same history;
* a straight run against a resumed one under ``training_random.gin`` and
  ``training_weakest.gin``: bit-identical, the random draws continued from
  the key in the sidecar."""

import csv
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu.engine import controller as jax_ctrl
from greedy_multimodal_learning_tpu.entries import train as jax_train
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch import entries as port_entries
from greedy_multimodal_learning_tpu_torch.data import get_mvdcndata
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer
from greedy_multimodal_learning_tpu_torch.engine import controller as port_ctrl
from greedy_multimodal_learning_tpu_torch.engine.callbacks import (
    Bias_Mitigation_AdaptiveWeakest,
    Bias_Mitigation_Random,
    Bias_Mitigation_Weakest,
)
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN

REPO = os.path.join(os.path.dirname(__file__), "..")
FIELDS = ("M_main", "M_bypass", "curation_mode", "caring_modality", "curation_step", "d_BDR")
EXACT = ("curation_mode", "caring_modality", "curation_step")
# M sums and d_BDR: the same float32 arithmetic, log10 in two libraries
BDR_RTOL, BDR_ATOL = 1e-5, 1e-6
STEPS = 40
CLOCK_COLUMNS = ("time", "epoch_begin_time", "train_samples_per_sec")
# The two packages' training runs from identical weights, batches and flips:
# at lr 1e-5 every step's loss agrees to about 2e-6 (the forwards' f32
# rounding); at lr 1e-3 this tiny network is chaotic and the two runs part
# by 15% within five steps.
LR = 1e-5
HISTORY_RTOL, HISTORY_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps the small convolutions from oversubscribing the cores."""
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


# ---- the update functions ---------------------------------------------------


def _port_state(jstate):
    return port_ctrl.ControllerState(**{f: torch.from_numpy(np.array(getattr(jstate, f))) for f in FIELDS})


def _assert_same(port, jstate, step):
    for f in FIELDS:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(jstate, f))
        assert got.dtype == want.dtype, (step, f, got.dtype, want.dtype)
        if f in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f"step {step} {f}")
        else:
            np.testing.assert_allclose(got, want, rtol=BDR_RTOL, atol=BDR_ATOL, err_msg=f"step {step} {f}")


def _sums(rng, n):
    return (rng.uniform(0.1, 2.0, 2 * n).astype(np.float32), rng.uniform(0.5, 3.0, 2 * n).astype(np.float32))


def _schedule(n):
    """(unlock, host target or None) for each step: locked at first, then
    targets set, cleared (-1) and changed while unlocked."""
    targets = {0: -1, 8: n - 1, 17: -1, 22: 0, 31: n - 1}
    return [(t >= 4 and t != 27, targets.get(t)) for t in range(STEPS)]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["weakest", "adaptive_weakest"])
def test_weakest_updates_match_jax(kind, n):
    rng = np.random.default_rng(n)
    if kind == "weakest":
        kw = dict(curation_windowsize=2, duty_period=5)
        jax_fn, port_fn = jax_ctrl.weakest_update, port_ctrl.weakest_update
    else:
        kw = dict(curation_windowsize=3)
        jax_fn, port_fn = jax_ctrl.adaptive_weakest_update, port_ctrl.adaptive_weakest_update
    jstate = jax_ctrl.init_controller_state(n)
    pstate = _port_state(jstate)
    modes = []
    for t, (unlock, target) in enumerate(_schedule(n)):
        if target is not None:  # what set_controller_target writes on each side
            jstate = jstate.replace(caring_modality=jnp.asarray(target, jnp.int32))
            pstate = dataclasses.replace(pstate, caring_modality=torch.tensor(target, dtype=torch.int32))
        gn, wn = _sums(rng, n)
        jstate = jax_fn(jstate, jnp.asarray(gn), jnp.asarray(wn), jnp.asarray(unlock), **kw)
        pstate = port_fn(pstate, torch.from_numpy(gn), torch.from_numpy(wn), torch.tensor(unlock), **kw)
        _assert_same(pstate, jstate, t)
        modes.append(bool(pstate.curation_mode))
    # the schedule opens and closes the gate: both flags occur while unlocked
    assert 5 < sum(modes) < STEPS - 10


@pytest.mark.parametrize("n", [2, 3])
def test_random_update_matches_jax_with_its_draws(n):
    rng = np.random.default_rng(10 + n)
    jstate = jax_ctrl.init_controller_state(n, seed=123)
    key = jstate.rng
    pstate = dataclasses.replace(_port_state(jstate), rng=torch.from_numpy(np.array(jstate.rng)))
    draws = []
    for t in range(STEPS):
        unlock = t >= 5
        key, sub = jax.random.split(key)  # controller.py:260-261
        mode = int(jax.random.randint(sub, (), 0, n + 1))
        draws.append(mode)
        gn, wn = _sums(rng, n)
        jstate = jax_ctrl.random_update(jstate, jnp.asarray(gn), jnp.asarray(wn), jnp.asarray(unlock), num_modalities=n)
        pstate = port_ctrl.random_update(pstate, torch.from_numpy(gn), torch.from_numpy(wn), torch.tensor(unlock),
                                         num_modalities=n)
        _assert_same(pstate, jstate, t)
        np.testing.assert_array_equal(port_ctrl.key_array(pstate.rng), np.asarray(key), err_msg=f"step {t}")
        if unlock and mode:
            want = (1 if mode == 1 else 0) if n == 2 else mode - 1
            assert int(pstate.caring_modality) == want
    assert set(draws) == set(range(n + 1))


def test_random_draws_are_uniform_locked_and_a_function_of_seed_and_step():
    """The state's key after step t is the t-th link of the seed's split
    chain, so the draw of step t is a function of (seed, t)."""
    state = port_ctrl.init_controller_state(2, seed=123)
    ones = torch.ones(4)
    for step in range(5):  # locked: always off
        state = port_ctrl.random_update(state, ones, ones, torch.tensor(False))
        assert not bool(state.curation_mode) and int(state.caring_modality) == 0
    modes = []
    for step in range(5, 305):
        _, draw = port_ctrl.random_draw(port_ctrl.key_array(state.rng), 2)
        assert isinstance(draw, int) and 0 <= draw <= 2
        np.testing.assert_array_equal(port_ctrl.key_array(state.rng), port_ctrl.controller_key(123, "random", step))
        state = port_ctrl.random_update(state, ones, ones, torch.tensor(True))
        assert bool(state.curation_mode) == (draw != 0)
        modes.append((bool(state.curation_mode), int(state.caring_modality)))
    counts = {
        "off": sum(1 for c, _ in modes if not c),
        "care0": sum(1 for c, m in modes if c and m == 0),
        "care1": sum(1 for c, m in modes if c and m == 1),
    }
    assert all(60 < v < 140 for v in counts.values()), counts
    # the same (seed, step): the same draw, again; another seed: other draws
    def draws(seed):
        return [port_ctrl.random_draw(port_ctrl.controller_key(seed, "random", s), 2)[1] for s in range(5, 45)]

    assert draws(123) == draws(123) != draws(124)


# ---- the callbacks --------------------------------------------------------------


class TrainerStub:
    nummodalities = 3

    def __init__(self, resumed=False):
        self.targets = []
        self.unlocked = False
        self.resets = 0
        self._skip_next_controller_reset = resumed

    def set_controller_target(self, m):
        self.targets.append(int(m))

    def unlock_controller(self):
        self.unlocked = True

    def reset_controller(self):
        self.resets += 1
        self._skip_next_controller_reset = False


LOGS = {"acc_modal_0": 90.0, "acc_modal_1": 80.0, "acc_modal_2": 70.0,
        "val_acc_modal_0": 85.0, "val_acc_modal_1": 60.0, "val_acc_modal_2": 75.0}


def test_weakest_callback_designates_the_argmin():
    cb = Bias_Mitigation_Weakest(starting_epoch=2, curation_windowsize=5, duty_period=10)
    assert cb.controller_kind == "weakest"
    assert cb.controller_config()["duty_period"] == 10
    tr = TrainerStub()
    cb.set_model_pytoune(tr)
    cb.on_train_begin({})
    assert tr.resets == 1 and tr.targets == [-1]
    cb.on_epoch_begin(1, {})
    assert not tr.unlocked
    cb.on_epoch_end(1, LOGS)
    assert tr.targets[-1] == 1  # the validation argmin, not the train argmin
    cb.on_epoch_begin(2, {})
    assert tr.unlocked
    cb.on_epoch_end(2, {k: v for k, v in LOGS.items() if not k.startswith("val_")})
    assert tr.targets[-1] == 2  # no validation split: the train accuracies
    n = len(tr.targets)
    cb.on_epoch_end(3, {"acc_modal_0": 90.0})  # incomplete logs keep the target
    assert len(tr.targets) == n
    train_cb = Bias_Mitigation_Weakest(monitor="train")
    train_cb.set_model_pytoune(tr)
    train_cb.on_epoch_end(4, LOGS)
    assert tr.targets[-1] == 2


def test_adaptive_callback_opens_the_gate_on_the_gap():
    cb = Bias_Mitigation_AdaptiveWeakest(min_gap=5.0, starting_epoch=1)
    tr = TrainerStub()
    cb.set_model_pytoune(tr)
    cb.on_train_begin({})
    cb.on_epoch_begin(1, {})
    assert tr.unlocked and tr.targets == [-1]
    cb.on_epoch_end(1, LOGS)  # val: 60 trails (85 + 75) / 2 = 80 by 20 points
    assert tr.targets[-1] == 1
    cb.on_epoch_end(2, {"val_acc_modal_0": 80.0, "val_acc_modal_1": 77.0, "val_acc_modal_2": 79.0})
    assert tr.targets[-1] == -1  # 77 trails 79.5 by 2.5: the gate closes
    cb.on_epoch_end(3, {"acc_modal_0": 50.0, "acc_modal_1": 70.0, "acc_modal_2": 70.0})
    assert tr.targets[-1] == 0  # train fallback, 20 points


@pytest.mark.parametrize("cls", [Bias_Mitigation_Weakest, Bias_Mitigation_AdaptiveWeakest])
def test_a_resume_keeps_the_restored_target(cls):
    tr = TrainerStub(resumed=True)
    cb = cls()
    cb.set_model_pytoune(tr)
    cb.on_train_begin({})
    assert tr.resets == 1 and tr.targets == []


@pytest.mark.parametrize("make, match", [
    (lambda: Bias_Mitigation_Weakest(curation_windowsize=11, duty_period=10), "must be smaller"),
    (lambda: Bias_Mitigation_Weakest(curation_windowsize=10, duty_period=10), "must be smaller"),
    (lambda: Bias_Mitigation_Weakest(curation_windowsize=0), ">= 1"),
    (lambda: Bias_Mitigation_Weakest(monitor="test"), "monitor"),
    (lambda: Bias_Mitigation_AdaptiveWeakest(curation_windowsize=0), ">= 1"),
    (lambda: Bias_Mitigation_AdaptiveWeakest(min_gap=-1.0), "min_gap"),
    (lambda: Bias_Mitigation_AdaptiveWeakest(monitor="test"), "monitor"),
], ids=["window_over_period", "window_equal_period", "window_zero", "weakest_monitor", "adaptive_window",
        "adaptive_gap", "adaptive_monitor"])
def test_callback_init_errors(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_random_callback_unlocks_at_its_starting_epoch():
    cb = Bias_Mitigation_Random()
    tr = TrainerStub()
    cb.set_model_pytoune(tr)
    cb.on_train_begin({})
    cb.on_epoch_begin(1, {})
    assert cb.controller_kind == "random" and cb.controller_config() == {"starting_epoch": 2}
    assert tr.resets == 1 and not tr.unlocked and tr.targets == []
    cb.on_epoch_begin(2, {})
    assert tr.unlocked


# ---- the trainer's hooks -------------------------------------------------------------


def _trainer(kind, **config):
    model = MMTMMVCNN(nclasses=4).to(memory_format=torch.channels_last)
    return Trainer(model, make_optimizer(model.parameters(), lr=0.01), controller_kind=kind,
                   controller_config=config, device="cpu", verbose=False)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_modelnet(str(tmp_path_factory.mktemp("data")), n_train=16, n_test=4, num_views=2,
                                   image_size=32, nclasses=4)


@pytest.mark.parametrize("kind, forced", [("weakest", True), ("adaptive_weakest", True), ("random", False),
                                          ("guided", False)])
def test_eval_passes_run_without_curation_under_the_weakest_controllers(root, kind, forced):
    config = {"curation_windowsize": 2, "duty_period": 4, "epsilon": 0.01}
    trainer = _trainer(kind, **config)
    trainer.set_controller_target(1)
    assert trainer.ctrl.caring_modality.dtype == torch.int32 and int(trainer.ctrl.caring_modality) == 1
    trainer.ctrl = dataclasses.replace(trainer.ctrl, curation_mode=torch.tensor(True))
    _, valid, _ = get_mvdcndata(root_dir=root, specific_views=[0, 1], batch_size=4, device="cpu")
    info = trainer._eval_generator(valid, "val")
    assert np.isfinite(info["val_loss"])
    assert bool(trainer.ctrl.curation_mode) is not forced  # and it is not restored
    assert int(trainer.ctrl.caring_modality) == 1


@pytest.mark.parametrize("kind", ["weakest", "adaptive_weakest"])
def test_weakest_controllers_check_for_empty_groups(kind):
    with pytest.raises(ValueError, match=f"{kind} controller: no parameters matched"):
        _trainer(kind, curation_windowsize=2, duty_period=4, branchnames=["net_view_0", "tower_x"])
    _trainer("random", branchnames=["net_view_0", "tower_x"])  # random reads no BDR sums


# ---- the train entry -----------------------------------------------------------


def _bindings(root, *extra):
    return [f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", "MMTM_MVCNN.nclasses=4",
            "train.batch_size=4", *extra]


def _history(save):
    with open(os.path.join(save, "history.csv")) as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(v) for v in r] for r in rows[1:]]


class _StepLog:
    """Spies on ``Trainer.train_batch``: each step's (step, curated, the
    decision's curation flag and target)."""

    def __init__(self):
        self.steps = []
        self._original = Trainer.train_batch

    def __enter__(self):
        log, original = self.steps, self._original

        def spy(trainer, data, flips, unlock):
            step = trainer.step
            out = original(trainer, data, flips, unlock)
            log.append((step, bool(out["curated"]), bool(out["curation_mode"]), int(out["caring_modality"])))
            return out

        Trainer.train_batch = spy
        return self

    def __exit__(self, *exc):
        Trainer.train_batch = self._original


def _port_train(config, root, save, *extra):
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings(
        [os.path.join(REPO, "configs", config)],
        "\n".join(_bindings(root, "train.device='cpu'", "MMTM_mitigate.use_pallas=True", *extra)))
    with _StepLog() as log:
        trainer = port_entries.train(str(save))
    return trainer, log.steps


def test_training_weakest_history_matches_jax(root, tmp_path):
    """``configs/training_weakest.gin`` (unlocked from epoch 1, 5-of-10 duty
    cycle) through both ``train`` entries, two epochs, from the seed alone:
    the port draws the JAX package's initial weights and flips itself, so
    the history (the per-modality validation accuracies the designation
    reads included) agrees; the target designated after epoch 1 is curated
    in epoch 2."""
    bindings = _bindings(root, f"train.lr={LR}", "training_loop.n_epochs=3")
    config = os.path.join(REPO, "configs", "training_weakest.gin")
    jax_cfg.parse_config_files_and_bindings([config], "\n".join(bindings))
    jax_train(str(tmp_path / "jax"))
    jax_cfg.clear_config()
    trainer, steps = _port_train("training_weakest.gin", root, tmp_path / "port", f"train.lr={LR}",
                                 "training_loop.n_epochs=3")
    j_cols, j_rows = _history(tmp_path / "jax")
    p_cols, p_rows = _history(tmp_path / "port")
    assert p_cols == j_cols and len(p_rows) == len(j_rows) == 2
    keep = [i for i, c in enumerate(j_cols) if c not in CLOCK_COLUMNS]
    np.testing.assert_allclose(np.array(p_rows)[:, keep], np.array(j_rows)[:, keep], rtol=HISTORY_RTOL,
                               atol=HISTORY_ATOL, err_msg=str([j_cols[i] for i in keep]))
    # 13 train samples (3 in val) in batches of 4: steps 0-3 in epoch 1, 4-7 in epoch 2
    row = dict(zip(p_cols, p_rows[0]))
    target = int(np.argmin([row["val_acc_modal_0"], row["val_acc_modal_1"]]))
    assert [s[0] for s in steps] == list(range(8))
    assert not any(curated for _, curated, _, _ in steps[:5])  # no target in epoch 1; eval forced off
    # the duty cycle: curation_step counts every unlocked step, on while step % 10 < 5
    assert [mode for _, _, mode, _ in steps] == [False] * 4 + [t % 10 < 5 for t in range(4, 8)]
    assert [caring for _, _, _, caring in steps] == [-1] * 4 + [target] * 4
    # each step's forward takes the decision of the step before, but epoch 2's
    # first forward comes after the eval passes turned curation off
    assert [curated for _, curated, _, _ in steps] == [False] * 5 + [True, False, False]
    assert trainer.curated_steps == 1


def _expected_random(seed, steps, starting_step):
    """The JAX package's decisions: step t draws from the t-th link of the
    seed's key chain (``controller.py:260-268``)."""
    out = []
    for t in steps:
        _, mode = port_ctrl.random_draw(port_ctrl.controller_key(seed, "random", t), 2)
        on = t >= starting_step and mode != 0
        out.append((on, (1 if mode == 1 else 0) if on else 0))
    return out


@pytest.mark.parametrize("config", ["training_random.gin", "training_weakest.gin"])
def test_resumed_run_is_bit_identical_to_the_straight_run(root, tmp_path, config):
    """Two epochs straight, against one epoch and a resume: the same
    history, parameters, buffers and controller bits, its key included.
    Under the random controller the resumed epoch draws what the straight
    one drew, from the key the sidecar holds: each step's draw that of the
    JAX package's key chain."""
    straight, s_steps = _port_train(config, root, tmp_path / "straight", "training_loop.n_epochs=3")
    _port_train(config, root, tmp_path / "resumed", "training_loop.n_epochs=2")
    resumed, r_steps = _port_train(config, root, tmp_path / "resumed", "training_loop.n_epochs=3",
                                   "training_loop.resume=True")
    assert [s[0] for s in r_steps] == [4, 5, 6, 7] and r_steps == s_steps[4:]
    cols, s_rows = _history(tmp_path / "straight")
    _, r_rows = _history(tmp_path / "resumed")
    keep = [i for i, c in enumerate(cols) if c not in CLOCK_COLUMNS]
    assert np.array(r_rows)[:, keep].tolist() == np.array(s_rows)[:, keep].tolist()
    assert resumed.step == straight.step == 8
    for key, value in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value), key
    for key, value in straight.ctrl.as_dict().items():
        assert torch.equal(getattr(resumed.ctrl, key), value), key
    if config == "training_random.gin":
        # unlocked from epoch 2 (step 4): each decision the JAX controller's
        want = _expected_random(777, range(8), 4)
        assert [(mode, caring) for _, _, mode, caring in s_steps] == want
        assert any(on for on, _ in want)
    else:
        assert int(straight.ctrl.curation_step) == 8 and int(straight.ctrl.caring_modality) >= 0
