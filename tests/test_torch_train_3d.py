"""The 3D family's train step at N=3 against the JAX package's, on the CPU
(3 modalities, width 0.25, 4 frames of 32², 4 classes, B=4 with a padded
row; 32² rather than the eval tests' 16² for the reason given in
``tests/test_torch_models_3d.py``):

* one guided train step (``jax.jit`` of ``build_train_step``) from identical
  state (parameters, BatchNorm statistics, MMTM buffers, controller), with
  the (B,) clip flips the JAX package draws fed to the port, curation off
  and curating each of the three modalities: the step outputs, the
  controller, BatchNorm statistics, MMTM buffers and every parameter's
  update;
* the BDR groups of the three towers and three MMTM branches (``flow``
  captures only its own ``mmtm*.fc_flow``), and the guided, random, weakest
  and adaptive-weakest updates at N=3 over a run of steps fed by both
  packages' group sums of the 3D model's tensors."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.engine import build_train_step, create_train_state
from greedy_multimodal_learning_tpu.engine import controller as jax_ctrl
from greedy_multimodal_learning_tpu.engine import make_optimizer as jax_make_optimizer
from greedy_multimodal_learning_tpu.engine.bdr import GroupReducer as JaxGroupReducer
from greedy_multimodal_learning_tpu.models import MMTM3DCNN as JaxMMTM3DCNN
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.engine import controller as port_ctrl
from greedy_multimodal_learning_tpu_torch.engine.bdr import GroupReducer, group_membership
from greedy_multimodal_learning_tpu_torch.models import MMTM3DCNN

B, M, T, IMG, NC, WIDTH = 4, 3, 4, 32, 4, 0.25
MASK = np.array([1, 1, 1, 0], np.float32)  # row 3 is padding
LR = 0.05
EPSILON, WINDOW = 1e-3, 3
BRANCHES = ["net_view_0", "net_view_1", "net_view_2"]
NAMES = ["rgb", "depth", "flow"]
FIELDS = ("M_main", "M_bypass", "curation_mode", "caring_modality", "curation_step", "d_BDR")
EXACT = ("curation_mode", "caring_modality", "curation_step")
# Forward quantities (loss, accuracies, BatchNorm statistics, MMTM running
# averages): f32 on both sides, summed in other orders.
FWD_TOL = (1e-4, 1e-5)
# Each parameter's update, r = ||port - jax||_2 / ||jax update||_2: clean
# arithmetic agrees to r ~ 6e-6, and the median tensor must stay within
# UPDATE_MEDIAN_TOL.  Over the step's ~10^6 ReLU inputs a few lie within f32
# rounding of zero and land on opposite sides in the two frameworks; each
# switches one element's gradient for the layers below it, moving one
# tower's early BatchNorm updates by up to r ~ 7e-3 (every tensor of the
# step that curates modality 1 stays within 1e-4 at these seeds).  A wrong
# term in the backward moves r by O(1); UPDATE_TOL is the bound of
# tests/test_torch_train_step.py for such switches.
UPDATE_MEDIAN_TOL, UPDATE_TOL = 1e-4, 5e-2
# The BDR sums are ratios of gradient sums of squares: f32 rounding of the
# gradients, summed over every parameter of a group.
BDR_RTOL, BDR_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps the small convolutions from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's model, initial state (with non-trivial MMTM
    buffers) and jitted guided step, compiled once for the module."""
    model = JaxMMTM3DCNN(nclasses=NC, num_towers=M, width_multiplier=WIDTH)
    opt = jax_make_optimizer(lr=LR)
    state = create_train_state(model, opt, jax.random.PRNGKey(1), jnp.zeros((B, M, T, IMG, IMG, 3)),
                               num_modalities=M)
    rng = np.random.default_rng(2)
    state = state.replace(mmtm={
        name: {**{k: jnp.asarray(rng.uniform(0.2, 0.8, v.shape).astype(np.float32)) for k, v in buffers.items()},
               "step": jnp.asarray(3.0)}
        for name, buffers in state.mmtm.items()
    })
    update = functools.partial(jax_ctrl.guided_update, epsilon=EPSILON, curation_windowsize=WINDOW)
    step = build_train_step(model, opt, JaxGroupReducer(state.params, BRANCHES, NAMES), update, donate=False)
    return state, step


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (B, M, T, IMG, IMG, 3), dtype=np.uint8),
        "labels": rng.integers(0, NC, B).astype(np.int32),
        "mask": MASK,
    }


@pytest.mark.parametrize("caring", [None, 0, 1, 2])
def test_guided_step_matches_jax(jax_step, caring):
    """One step from identical state; ``caring`` None: curation off (the
    step may enter a window), else curating that modality in its window's
    second step."""
    state, step = jax_step
    ctrl = state.controller.replace(
        M_main=jnp.asarray([3.0, 2.0, 4.0], jnp.float32), M_bypass=jnp.asarray([0.5, 0.9, 0.2], jnp.float32),
        curation_mode=jnp.asarray(caring is not None), caring_modality=jnp.asarray(caring or 0, jnp.int32),
        curation_step=jnp.asarray(1, jnp.int32), d_BDR=jnp.asarray(0.3, jnp.float32))
    state = state.replace(controller=ctrl)
    batch = _batch(10 + (caring or 0))

    port = MMTM3DCNN(nclasses=NC, width_multiplier=WIDTH).to(memory_format=torch.channels_last_3d)
    before = state_dict_from_jax(state.params, state.batch_stats, state.mmtm)
    port.load_state_dict(before, strict=False)
    trainer = Trainer(
        port,
        make_optimizer(port.parameters(), lr=LR),
        controller_kind="guided",
        controller_config={"epsilon": EPSILON, "curation_windowsize": WINDOW, "branchnames": BRANCHES,
                           "mmtm_names": NAMES},
        nummodalities=M,
        device="cpu",
    )
    trainer.ctrl = port_ctrl.ControllerState(**{f: torch.from_numpy(np.array(getattr(ctrl, f))) for f in FIELDS})
    flips = np.asarray(jax.random.bernoulli(jax.random.fold_in(state.rng, state.step), 0.5, (B,)))  # steps.py:88

    new_state, j_out = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(True))
    t_out = trainer.train_batch({k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(flips),
                                torch.tensor(True))

    assert bool(t_out["curated"]) is (caring is not None)
    for key in ("loss", "acc", "acc_modal"):
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), *FWD_TOL, err_msg=key)
    assert t_out["acc_modal"].shape == (M,)
    for f in FIELDS:
        got, want = getattr(trainer.ctrl, f).numpy(), np.asarray(getattr(new_state.controller, f))
        assert got.dtype == want.dtype, f
        if f in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=BDR_RTOL, atol=BDR_ATOL, err_msg=f)

    after, got = state_dict_from_jax(new_state.params, new_state.batch_stats, new_state.mmtm), port.state_dict()
    params, ratios = {n for n, _ in port.named_parameters()}, []
    for key, want in after.items():
        if key in params:
            err, update = float((got[key] - want).norm()), float((want - before[key]).norm())
            assert err <= UPDATE_TOL * update + 1e-7, (key, err, update)
            if update:  # the curated modality's fc_<name> takes no gradient
                ratios.append(err / update)
        else:  # BatchNorm statistics, MMTM running averages and step
            np.testing.assert_allclose(got[key].numpy(), want.numpy(), *FWD_TOL, err_msg=key)
    assert np.median(ratios) <= UPDATE_MEDIAN_TOL, np.median(ratios)
    assert float(got["mmtm4.step"]) == 4.0


# ---- BDR groups and the controllers at N=3 ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    model = JaxMMTM3DCNN(nclasses=NC, num_towers=M, width_multiplier=WIDTH)
    return create_train_state(model, None, jax.random.PRNGKey(3), jnp.zeros((2, M, T, 16, 16, 3)),
                              num_modalities=M).params


def test_bdr_groups_at_n3():
    port = MMTM3DCNN(nclasses=NC, width_multiplier=WIDTH)
    names = [n for n, _ in port.named_parameters()]
    rows = dict(zip(names, group_membership(names, BRANCHES, NAMES)))
    # columns: main rgb, depth, flow, then bypass rgb, depth, flow
    assert rows["mmtm3.fc_flow.weight"] == (0, 0, 0, 0, 0, 1)
    assert rows["mmtm3.fc_rgb.bias"] == (0, 0, 0, 1, 0, 0)
    assert rows["mmtm2.fc_squeeze.weight"] == (0, 0, 0, 1, 1, 1)  # shared: every bypass group
    assert rows["net_view_2.layer3.0.conv1.weight"] == (0, 0, 1, 0, 0, 0)
    flow = [n for n, r in rows.items() if r[5] and not all(r[3:])]
    assert sorted(flow) == sorted(f"mmtm{k}.fc_flow.{p}" for k in (2, 3, 4) for p in ("weight", "bias"))
    assert not GroupReducer(names, BRANCHES, NAMES).empty_groups


def _gradient_like(params, rng):
    """A tree shaped like ``params`` whose leaves are random multiples of
    theirs, so every step's group sums differ."""
    return jax.tree_util.tree_map(lambda p: p * np.float32(rng.uniform(0.05, 2.0)), params)


@pytest.mark.parametrize("kind", ["guided", "random", "weakest", "adaptive_weakest"])
def test_controller_updates_at_n3_match_jax(jax_params, kind):
    """Twelve steps of each update from the same state, each side fed its own
    package's group sums of the same 3D-model tensors (the sums agree); the
    weakest controllers with a host target set after step 3, the random one
    splitting the key it carries as the JAX package's does: every field,
    and the key, at every step."""
    port = MMTM3DCNN(nclasses=NC, width_multiplier=WIDTH)
    names = [n for n, _ in port.named_parameters()]
    j_reduce = JaxGroupReducer(jax_params, BRANCHES, NAMES)
    t_reduce = GroupReducer(names, BRANCHES, NAMES)
    kw = {
        "guided": dict(epsilon=EPSILON, curation_windowsize=WINDOW),
        "weakest": dict(curation_windowsize=2, duty_period=4),
        "adaptive_weakest": dict(curation_windowsize=WINDOW),
        "random": dict(num_modalities=M),
    }[kind]
    j_fn, t_fn = getattr(jax_ctrl, f"{kind}_update"), getattr(port_ctrl, f"{kind}_update")
    jstate = jax_ctrl.init_controller_state(M, seed=5)
    # the port's state starts with the JAX state's key and splits it itself
    tstate = port_ctrl.ControllerState(**{f: torch.from_numpy(np.array(getattr(jstate, f))) for f in FIELDS + ("rng",)})
    key, rng, modes, draws = jstate.rng, np.random.default_rng(6), [], []

    def sums(tree):
        flat = state_dict_from_jax(tree, {})
        return np.asarray(j_reduce(tree)), t_reduce([flat[n] for n in names])

    for t in range(12):
        unlock = t >= 2
        if kind in ("weakest", "adaptive_weakest") and t == 3:  # what set_controller_target writes on each side
            jstate = jstate.replace(caring_modality=jnp.asarray(2, jnp.int32))
            tstate = dataclasses.replace(tstate, caring_modality=torch.tensor(2, dtype=torch.int32))
        (j_gn, t_gn), (j_wn, t_wn) = sums(_gradient_like(jax_params, rng)), sums(jax_params)
        np.testing.assert_allclose(t_gn.numpy(), j_gn, rtol=1e-5)
        np.testing.assert_allclose(t_wn.numpy(), j_wn, rtol=1e-5)
        args = (jnp.asarray(j_gn), jnp.asarray(j_wn), jnp.asarray(unlock))
        jstate = j_fn(jstate, *args, **kw)
        if kind == "random":
            key, sub = jax.random.split(key)  # controller.py:260-261
            draws.append(int(jax.random.randint(sub, (), 0, M + 1)))
        tstate = t_fn(tstate, torch.from_numpy(j_gn), torch.from_numpy(j_wn), torch.tensor(unlock), **kw)
        np.testing.assert_array_equal(port_ctrl.key_array(tstate.rng), np.asarray(jstate.rng), err_msg=f"step {t}")
        for f in FIELDS:
            got, want = getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f))
            assert got.dtype == want.dtype, (t, f)
            if f in EXACT:
                np.testing.assert_array_equal(got, want, err_msg=f"step {t} {f}")
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"step {t} {f}")
        modes.append((bool(tstate.curation_mode), int(tstate.caring_modality)))
    assert any(on for on, _ in modes), modes  # each controller curated at least once
    if kind == "random":  # mode - 1 for each modality, with the JAX package's draws
        assert {c for on, c in modes if on} == {0, 1, 2}, draws
