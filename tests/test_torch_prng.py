"""The port's random streams (``greedy_multimodal_learning_tpu_torch/utils/prng.py``)
against the JAX package's, on the CPU, from ``train.seed`` alone:

* ``PRNGKey``, ``split``, ``fold_in`` and the partitionable random bits
  bit-identical to JAX for seeds 0, 777, 2**31 - 1 and drawn ones, odd
  shapes included; ``uniform``, ``bernoulli`` and ``randint`` (N + 1 = 3 and
  4) bit-identical; ``normal`` within NORMAL_ULPS float32 ulps (XLA's
  ``log1p`` inside ``erf_inv`` rounds otherwise than numpy's);
* the initialization of both families (2-D plain, ``SEonly`` and
  ``shareweight``, 3-D at 3 modalities) equal to flax's ``model.init``
  mapped by ``state_dict_from_jax``: uniform-drawn and constant tensors
  bit for bit, normal-drawn ones within NORMAL_ULPS; each parameter's key
  equal to flax's ``_fold_in_static`` of its scope path;
* the train flips of 10 steps, (B, V) and (B,), and two data ranks' blocks
  joined, bit-identical to ``bernoulli(fold_in(rng, step))``; the port's
  ``preprocess`` under a key equal to the JAX package's;
* the random controller's 20 decisions and keys those of the JAX package,
  and a resume at step 10 from the port's sidecar, from a ``.jax.pkl`` and
  from a sidecar without keys continuing the same sequence;
* one whole run of each package's ``train`` entry from the seed alone
  (``configs/training_random.gin``, 3 epochs, nothing fed in): the same
  curation decisions each step, the histories within HISTORY_TOL, the
  final parameters within WEIGHT_TOL, their statistics within HISTORY_TOL.
"""

import csv
import logging
import os
import shutil

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

from flax.core.scope import _fold_in_static as flax_fold_in_static
from greedy_multimodal_learning_tpu import config as jax_cfg
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu.data.transforms import preprocess as jax_preprocess
from greedy_multimodal_learning_tpu.engine import controller as jax_ctrl
from greedy_multimodal_learning_tpu.engine import create_train_state
from greedy_multimodal_learning_tpu.engine import make_optimizer as jax_make_optimizer
from greedy_multimodal_learning_tpu.engine.checkpoint import save_weights as jax_save_weights
from greedy_multimodal_learning_tpu.entries import train as jax_train
from greedy_multimodal_learning_tpu.models import MMTM3DCNN as JaxMMTM3DCNN
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch import parallel
from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.data.transforms import preprocess
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer, save_weights, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.engine import controller as port_ctrl
from greedy_multimodal_learning_tpu_torch.engine.checkpoint import read_jax_sidecar
from greedy_multimodal_learning_tpu_torch.engine.train_state import train_keys
from greedy_multimodal_learning_tpu_torch.entries import train as port_train
from greedy_multimodal_learning_tpu_torch.models import MMTM3DCNN, MMTMMVCNN
from greedy_multimodal_learning_tpu_torch.models.layers import jax_init_tree, jax_param_path
from greedy_multimodal_learning_tpu_torch.utils import prng

REPO = os.path.join(os.path.dirname(__file__), "..")
SEEDS = (0, 777, 2**31 - 1)
SHAPES = ((), (1,), (3,), (5, 7), (2, 3, 5), (1001,))
# normal = sqrt(2) erf_inv(u): XLA's float32 log1p and numpy's part by up to
# 2 ulps, which the polynomial and the two products carry to at most 4
NORMAL_ULPS = 4
# The two packages' whole runs: the same initialization (within NORMAL_ULPS),
# batches, flips and decisions; at lr 1e-5 every epoch's metrics agree to
# the forwards' float32 rounding (at lr 1e-3 the tiny network is chaotic
# and two runs part within a few steps; tests/test_torch_controllers.py).
LR = 1e-5
HISTORY_TOL = (1e-4, 1e-5)  # rtol, atol
# the final parameters; the BatchNorm statistics and MMTM averages are
# forward quantities, held to the history's tolerance
WEIGHT_TOL = (1e-5, 1e-6)
CLOCK_COLUMNS = ("time", "epoch_begin_time", "train_samples_per_sec")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
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


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.size == 0:
        return 0
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


# ---- keys and samplers -----------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS + (-1, 123457))
def test_keys_split_and_fold_in_are_jax_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(key))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num), np.asarray(jax.random.split(key, num)))
    for data in (0, 1, 17, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(seed), data), np.asarray(jax.random.fold_in(key, data)))
    np.testing.assert_array_equal(prng.key_chain(prng.PRNGKey(seed), 3),
                                  np.asarray(jax.random.split(jax.random.split(jax.random.split(key)[0])[0])[0]))


@pytest.mark.parametrize("seed", [2**31, 2**32 - 1, 2**32 + 5, -2**31 - 1, 2**63 - 1])
def test_a_seed_outside_int32_wraps_as_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_samplers_are_jax_bit_for_bit(seed, shape):
    key, mine = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.random_bits(mine, shape), np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform(mine, shape), np.asarray(jax.random.uniform(key, shape)))
    np.testing.assert_array_equal(prng.uniform(mine, shape, -0.3, 0.7),
                                  np.asarray(jax.random.uniform(key, shape, jnp.float32, -0.3, 0.7)))
    np.testing.assert_array_equal(prng.bernoulli(mine, 0.5, shape), np.asarray(jax.random.bernoulli(key, 0.5, shape)))
    for n in (3, 4):
        got, want = prng.randint(mine, shape, 0, n), np.asarray(jax.random.randint(key, shape, 0, n))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert _ulps(prng.normal(mine, shape), jax.random.normal(key, shape)) <= NORMAL_ULPS


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(-2**31, 2**31 - 1), data=st.integers(0, 2**32 - 1),
       shape=st.lists(st.integers(1, 9), min_size=0, max_size=3).map(tuple))
def test_drawn_keys_and_shapes_are_jax_bit_for_bit(seed, data, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    mine = prng.fold_in(prng.PRNGKey(seed), data)
    np.testing.assert_array_equal(mine, np.asarray(key))
    np.testing.assert_array_equal(prng.random_bits(mine, shape), np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    np.testing.assert_array_equal(prng.bernoulli(mine, 0.5, shape), np.asarray(jax.random.bernoulli(key, 0.5, shape)))
    np.testing.assert_array_equal(prng.randint(mine, shape, 0, 3), np.asarray(jax.random.randint(key, shape, 0, 3)))
    assert _ulps(prng.normal(mine, shape), jax.random.normal(key, shape)) <= NORMAL_ULPS


def test_a_large_normal_draw_stays_within_the_ulp_bound():
    """400k normals (the blocks of the threaded draw included): within
    NORMAL_ULPS everywhere, equal bits almost everywhere."""
    key = jax.random.PRNGKey(5)
    got, want = prng.normal(prng.PRNGKey(5), (400_000,)), np.asarray(jax.random.normal(key, (400_000,)))
    assert _ulps(got, want) <= NORMAL_ULPS
    assert (got != want).mean() < 0.02


@pytest.mark.parametrize("parts", [("net_view_0", "conv1", 1), ("mmtm2", "fc_squeeze", 2), ("fc", 1), ()])
def test_static_fold_in_is_flax(parts):
    key = jax.random.PRNGKey(9)
    np.testing.assert_array_equal(prng.fold_in_static(prng.PRNGKey(9), parts),
                                  np.asarray(flax_fold_in_static(key, parts)))


# ---- initialization --------------------------------------------------------


def _flax_init(jax_model, sample, seed):
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))  # create_train_state
    return init_rng, jax_model.init(init_rng, sample, train=False)


def _check_init(port_model, jax_model, sample, seed):
    init_rng, variables = _flax_init(jax_model, sample, seed)
    want = state_dict_from_jax(variables["params"], variables["batch_stats"], variables.get("mmtm"))
    got = init_model(port_model, seed, "cpu").state_dict()
    assert set(want) == {k for k in got if not k.endswith("num_batches_tracked")}
    normal = {n for n, m in port_model.named_modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))}
    for name, value in want.items():
        if name.rpartition(".")[0] in normal:
            assert _ulps(got[name], value) <= NORMAL_ULPS, name
        else:
            np.testing.assert_array_equal(got[name].numpy(), value.numpy(), err_msg=name)
    # each parameter's key: flax's fold-in of its scope path and counter
    for name, _ in port_model.named_parameters():
        owner = port_model.get_submodule(name.rpartition(".")[0])
        path = jax_param_path(name, isinstance(owner, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)))
        counter = 2 if path[-1] == "bias" else 1
        np.testing.assert_array_equal(prng.fold_in_static(train_keys(seed)[0], path[:-1] + (counter,)),
                                      np.asarray(flax_fold_in_static(init_rng, path[:-1] + (counter,))), err_msg=name)


@pytest.mark.parametrize("kwargs, seed", [({}, 777), ({"SEonly": True}, 0), ({"shareweight": True}, 2**31 - 1)])
def test_2d_init_is_flax_init(kwargs, seed):
    _check_init(MMTMMVCNN(nclasses=4, **kwargs), JaxMMTMMVCNN(nclasses=4, **kwargs), jnp.zeros((2, 2, 32, 32, 3)),
                seed)


def test_3d_init_at_3_modalities_is_flax_init():
    _check_init(MMTM3DCNN(nclasses=4, width_multiplier=0.25),
                JaxMMTM3DCNN(nclasses=4, num_towers=3, width_multiplier=0.25), jnp.zeros((2, 3, 4, 16, 16, 3)), 11)


def test_init_tree_names_every_parameter_and_is_deterministic():
    model = MMTMMVCNN(nclasses=4)
    a, b = jax_init_tree(model, prng.PRNGKey(1)), jax_init_tree(model, prng.PRNGKey(1))
    flat = state_dict_from_jax(a, {})
    assert set(flat) == {n for n, _ in model.named_parameters()}
    for k, v in state_dict_from_jax(b, {}).items():
        assert torch.equal(v, flat[k]), k
    other = state_dict_from_jax(jax_init_tree(model, prng.PRNGKey(2)), {})
    assert not torch.equal(other["net_view_0.conv1.weight"], flat["net_view_0.conv1.weight"])


# ---- flips -----------------------------------------------------------------


def _flip_trainer(seed, world=None):
    return Trainer(None, seed=seed, device="cpu", world=world)


@pytest.mark.parametrize("seed", (777, 3))
@pytest.mark.parametrize("shape", [(8, 2), (6,)])
def test_train_flips_are_jax_over_ten_steps(seed, shape):
    trainer = _flip_trainer(seed)
    _, data_rng = jax.random.split(jax.random.PRNGKey(seed))  # create_train_state's data key
    for step in range(10):
        trainer.step = step
        want = np.asarray(jax.random.bernoulli(jax.random.fold_in(data_rng, step), 0.5, shape))  # steps.py:88
        got = trainer.train_flips(*shape)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"step {step}")


def test_two_data_ranks_flips_join_into_jax_draws():
    ranks = [_flip_trainer(777, parallel.World(size=2, rank=r, local_size=2)) for r in range(2)]
    _, data_rng = jax.random.split(jax.random.PRNGKey(777))
    for step in (0, 4, 9):
        for t in ranks:
            t.step = step
        key = jax.random.fold_in(data_rng, step)
        np.testing.assert_array_equal(torch.cat([t.train_flips(4, 2) for t in ranks]).numpy(),
                                      np.asarray(jax.random.bernoulli(key, 0.5, (8, 2))))
        np.testing.assert_array_equal(torch.cat([t.train_flips(3) for t in ranks]).numpy(),
                                      np.asarray(jax.random.bernoulli(key, 0.5, (6,))))


@pytest.mark.parametrize("shape", [(4, 2, 8, 8, 3), (3, 3, 2, 8, 8, 3)])
def test_preprocess_under_a_key_is_jax_preprocess(shape):
    images = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_preprocess(jnp.asarray(images), train=True, rng=key))
    got = preprocess(torch.from_numpy(images), train=True, key=prng.PRNGKey(4)).numpy()
    np.testing.assert_array_equal(got, want)


# ---- the random controller -------------------------------------------------


def _jax_decisions(seed, n, steps, state=None, unlocked_from=0):
    """(decisions, states) of the JAX package's random controller, unlocked
    from step ``unlocked_from``."""
    state = state if state is not None else jax_ctrl.init_controller_state(n, seed)
    ones = jnp.ones(2 * n)
    decisions, states = [], []
    for t in range(steps):
        state = jax_ctrl.random_update(state, ones, ones, jnp.asarray(t >= unlocked_from), num_modalities=n)
        decisions.append((bool(state.curation_mode), int(state.caring_modality)))
        states.append(state)
    return decisions, states


def _port_decisions(trainer, steps):
    ones = torch.ones(2 * trainer.nummodalities)
    out = []
    for _ in range(steps):
        trainer.ctrl = trainer._controller_update(trainer.ctrl, ones, ones, torch.tensor(True))
        trainer.step += 1
        out.append((bool(trainer.ctrl.curation_mode), int(trainer.ctrl.caring_modality)))
    return out


def _random_trainer(model, seed=777):
    return Trainer(model, make_optimizer(model.parameters(), lr=0.1), controller_kind="random",
                   nummodalities=model.num_towers, seed=seed, device="cpu", verbose=False)


@pytest.mark.parametrize("n", [2, 3])
def test_twenty_random_decisions_and_keys_are_jax(n):
    want, states = _jax_decisions(777, n, 20)
    state = port_ctrl.init_controller_state(n, seed=777)
    ones = torch.ones(2 * n)
    for t, (decision, jstate) in enumerate(zip(want, states)):
        state = port_ctrl.random_update(state, ones, ones, torch.tensor(True), num_modalities=n)
        assert (bool(state.curation_mode), int(state.caring_modality)) == decision, t
        assert state.caring_modality.dtype == torch.int32
        np.testing.assert_array_equal(port_ctrl.key_array(state.rng), np.asarray(jstate.rng))
    assert len(set(want)) == n + 1  # every outcome occurs


@pytest.fixture(scope="module")
def model_2d():
    return MMTMMVCNN(nclasses=4)


def test_the_train_begin_reset_keeps_the_key(model_2d):
    trainer = _random_trainer(model_2d)
    _port_decisions(trainer, 3)
    key = trainer.ctrl.rng.clone()
    trainer.reset_controller()
    assert torch.equal(trainer.ctrl.rng, key) and not bool(trainer.ctrl.curation_mode)
    want, _ = _jax_decisions(777, 2, 6)
    assert _port_decisions(trainer, 3) == want[3:]


def test_a_resume_from_the_port_sidecar_continues_the_draws(model_2d, tmp_path):
    want, _ = _jax_decisions(777, 2, 20)
    trainer = _random_trainer(model_2d)
    assert _port_decisions(trainer, 10) == want[:10]
    path = str(tmp_path / "model_last_epoch.pt")
    save_weights(model_2d, path, optimizer=trainer.optimizer, controller=trainer.ctrl.as_dict(), step=trainer.step,
                 rng=port_ctrl.key_tensor(trainer.data_key))
    resumed = _random_trainer(MMTMMVCNN(nclasses=4), seed=5)  # another seed: the keys come from the file
    resumed.restore(path)
    assert resumed.step == 10
    np.testing.assert_array_equal(resumed.data_key, train_keys(777)[1])
    assert _port_decisions(resumed, 10) == want[10:]


def test_a_sidecar_without_keys_resumes_with_keys_from_the_seed(model_2d, tmp_path, caplog):
    """A sidecar written before the port carried the keys: the data key is
    the seed's, the random controller's key the 10th link of its chain."""
    want, _ = _jax_decisions(777, 2, 20)
    trainer = _random_trainer(model_2d)
    _port_decisions(trainer, 10)
    path = str(tmp_path / "model_last_epoch.pt")
    ctrl = {k: v for k, v in trainer.ctrl.as_dict().items() if k != "rng"}
    save_weights(model_2d, path, optimizer=trainer.optimizer, controller=ctrl, step=trainer.step)
    side = torch.load(f"{path}.torch.pt", weights_only=True)
    assert side["rng"] is None and "rng" not in side["controller"]
    resumed = _random_trainer(MMTMMVCNN(nclasses=4))
    with caplog.at_level(logging.INFO):
        resumed.restore(path)
    assert "holds no controller key" in caplog.text and "holds no data key" in caplog.text
    np.testing.assert_array_equal(resumed.data_key, train_keys(777)[1])
    assert _port_decisions(resumed, 10) == want[10:]
    np.testing.assert_array_equal(port_ctrl.controller_key(777, "guided", 10), prng.PRNGKey(777))


def test_a_resume_from_a_jax_sidecar_keeps_both_keys(tmp_path):
    """The JAX package's checkpoint after 10 random steps (its controller key
    and data key in the ``.jax.pkl``): the port continues its draws and its
    flips."""
    jmodel = JaxMMTMMVCNN(nclasses=4)
    state = create_train_state(jmodel, jax_make_optimizer(lr=0.1), jax.random.PRNGKey(31), jnp.zeros((2, 2, 32, 32, 3)),
                               controller_seed=31)
    want, states = _jax_decisions(31, 2, 20, state.controller)
    state = state.replace(controller=states[9], step=jnp.asarray(10, jnp.int32))
    path = str(tmp_path / "model_last_epoch.pt")
    jax_save_weights(state, path)
    trainer = _random_trainer(MMTMMVCNN(nclasses=4), seed=777)
    trainer.restore(path)
    assert trainer.step == 10
    np.testing.assert_array_equal(trainer.data_key, np.asarray(state.rng))
    np.testing.assert_array_equal(port_ctrl.key_array(trainer.ctrl.rng), np.asarray(states[9].rng))
    want_flips = np.asarray(jax.random.bernoulli(jax.random.fold_in(state.rng, 10), 0.5, (4, 2)))
    np.testing.assert_array_equal(trainer.train_flips(4, 2).numpy(), want_flips)
    assert _port_decisions(trainer, 10) == want[10:]


# ---- a whole run from the seed ----------------------------------------------


def _bindings(root, *extra):
    return [f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", "MMTM_MVCNN.nclasses=4",
            "train.batch_size=4", f"train.lr={LR}", "training_loop.n_epochs=4", *extra]


def _history(save):
    with open(os.path.join(save, "history.csv")) as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(v) for v in r] for r in rows[1:]]


@pytest.fixture(scope="module")
def whole_runs(tmp_path_factory):
    """Both packages' ``train`` under ``configs/training_random.gin`` on one
    synthetic split, 3 epochs, from the seed alone; the port's decision of
    each step logged as its trainer takes it."""
    base = tmp_path_factory.mktemp("whole")
    root = make_synthetic_modelnet(str(base / "data"), n_train=16, n_test=4, num_views=2, image_size=32, nclasses=4)
    config = os.path.join(REPO, "configs", "training_random.gin")
    jax_cfg.clear_config()
    jax_cfg.parse_config_files_and_bindings([config], "\n".join(_bindings(root)))
    try:
        jax_train(str(base / "jax"))
    finally:
        jax_cfg.clear_config()

    decisions, original = [], Trainer.train_batch

    def spy(trainer, data, flips, unlock):
        out = original(trainer, data, flips, unlock)
        decisions.append((bool(out["curation_mode"]), int(out["caring_modality"])))
        return out

    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings(
        [config], "\n".join(_bindings(root, "train.device='cpu'", "MMTM_mitigate.use_pallas=True")))
    Trainer.train_batch = spy
    try:
        trainer = port_train(str(base / "port"))
    finally:
        Trainer.train_batch = original
        port_cfg.clear_config()
    yield {"base": base, "decisions": decisions, "trainer": trainer}
    shutil.rmtree(base, ignore_errors=True)


def test_a_whole_run_from_the_seed_matches_jax(whole_runs):
    base, trainer = whole_runs["base"], whole_runs["trainer"]
    cols, j_rows = _history(base / "jax")
    p_cols, p_rows = _history(base / "port")
    assert p_cols == cols and len(p_rows) == len(j_rows) == 3
    keep = [i for i, c in enumerate(cols) if c not in CLOCK_COLUMNS]
    np.testing.assert_allclose(np.array(p_rows)[:, keep], np.array(j_rows)[:, keep], rtol=HISTORY_TOL[0],
                               atol=HISTORY_TOL[1], err_msg=str([cols[i] for i in keep]))
    # the final weights: the JAX package's last checkpoint, read through its sidecar
    side = read_jax_sidecar(str(base / "jax" / "model_last_epoch.pt.jax.pkl"))
    want = state_dict_from_jax(side["params"], side["batch_stats"], side["mmtm"])
    got = trainer.model.state_dict()
    params = {n for n, _ in trainer.model.named_parameters()}
    assert params < set(want)
    for name, value in want.items():
        rtol, atol = WEIGHT_TOL if name in params else HISTORY_TOL
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=rtol, atol=atol, err_msg=name)
    assert int(np.asarray(side["step"])) == trainer.step == 12
    np.testing.assert_array_equal(port_ctrl.key_array(trainer.ctrl.rng), np.asarray(side["controller"]["rng"]))
    np.testing.assert_array_equal(trainer.data_key, np.asarray(side["rng"]))


def test_a_whole_run_takes_jax_curation_decisions(whole_runs):
    """13 train samples in batches of 4: 4 steps an epoch, unlocked from
    epoch 2 (step 4).  The port's 12 decisions are the JAX controller's
    over the same schedule, whose key the JAX run's checkpoint holds at the
    end (so the JAX run drew the same 12)."""
    want, states = _jax_decisions(777, 2, 12, unlocked_from=4)
    assert whole_runs["decisions"] == want
    assert any(on for on, _ in want[4:]) and not any(on for on, _ in want[:4])
    side = read_jax_sidecar(str(whole_runs["base"] / "jax" / "model_last_epoch.pt.jax.pkl"))
    np.testing.assert_array_equal(np.asarray(side["controller"]["rng"]), np.asarray(states[-1].rng))
