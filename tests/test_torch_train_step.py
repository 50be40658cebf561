"""Three guided train steps of the port against three of the JAX package's
(``jax.jit`` of ``build_train_step``) on the same batches, with the flips
JAX draws fed to the port, on both gating paths (the Pallas kernels in
interpret mode on the JAX side, the autograd Function with the plain
versions on the port's): the step outputs, every controller field,
BatchNorm statistics, MMTM buffers and parameters.

Before each step the port takes the JAX package's state (parameters,
BatchNorm statistics, MMTM buffers, controller), so each step is compared
from identical weights.  Run freely, this tiny network (32², five valid
rows) is chaotic at lr 0.05, and the two trajectories part within three
steps for reasons unrelated to the step's arithmetic."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from greedy_multimodal_learning_tpu.engine import build_train_step, create_train_state
from greedy_multimodal_learning_tpu.engine import make_optimizer as jax_make_optimizer
from greedy_multimodal_learning_tpu.engine.bdr import GroupReducer as JaxGroupReducer
from greedy_multimodal_learning_tpu.engine.controller import guided_update as jax_guided_update
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.engine.controller import ControllerState
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN

B, V, IMG, NC, STEPS = 6, 2, 32, 4, 3
MASK = np.array([1, 1, 1, 1, 1, 0], np.float32)  # one padded row
LR, WD = 0.05, 5e-4
EPSILON, WINDOW = 1e-3, 2  # curation enters after step 1, runs steps 2 and 3 and leaves after step 3
FIELDS = ("M_main", "M_bypass", "curation_mode", "caring_modality", "curation_step", "d_BDR")

# Forward quantities (loss, accuracies, BatchNorm statistics, MMTM running
# averages): f32 on both sides, summed in other orders.
FWD_TOL = (1e-4, 1e-5)
# Each parameter's update, ||port - jax||_2 <= UPDATE_TOL * ||jax update||_2.
# Clean steps agree to ~1e-4; a ReLU input within rounding distance of zero
# (under one per step at this size) lands on opposite sides in the two
# frameworks and switches one element's gradient, moving the updates of the
# layers below it by up to ~2% in L2.  A wrong term in the backward moves
# them by O(1).
UPDATE_TOL = 5e-2
# The BDR accumulators and d_BDR are ratios of gradient sums of squares,
# which such a switch moves by under 1%.
BDR_RTOL = 2e-2


def _batches():
    rng = np.random.default_rng(0)
    return [
        {
            "images": rng.integers(0, 256, (B, V, IMG, IMG, 3), dtype=np.uint8),
            "labels": rng.integers(0, NC, B).astype(np.int32),
            "mask": MASK,
        }
        for _ in range(STEPS)
    ]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_three_steps_match_jax(use_pallas):
    model = JaxMMTMMVCNN(nclasses=NC, use_pallas=use_pallas)
    opt = jax_make_optimizer(lr=LR, weight_decay=WD)
    state = create_train_state(model, opt, jax.random.PRNGKey(1), jnp.zeros((B, V, IMG, IMG, 3)))
    update = functools.partial(jax_guided_update, epsilon=EPSILON, curation_windowsize=WINDOW)
    step = build_train_step(model, opt, JaxGroupReducer(state.params), update, donate=False)

    port = MMTMMVCNN(nclasses=NC, use_pallas=use_pallas).to(memory_format=torch.channels_last)
    trainer = Trainer(
        port,
        make_optimizer(port.parameters(), lr=LR, weight_decay=WD),
        controller_kind="guided",
        controller_config={"epsilon": EPSILON, "curation_windowsize": WINDOW},
        device="cpu",
    )
    modes = []
    for t, batch in enumerate(_batches()):
        before = state_dict_from_jax(state.params, state.batch_stats, state.mmtm)
        port.load_state_dict(before, strict=False)
        trainer.ctrl = ControllerState(**{f: torch.from_numpy(np.array(getattr(state.controller, f))) for f in FIELDS})
        flips = np.asarray(jax.random.bernoulli(jax.random.fold_in(state.rng, state.step), 0.5, (B, V)))  # steps.py:88

        state, j_out = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(True))
        t_out = trainer.train_batch({k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(flips),
                                    torch.tensor(True))

        for key in ("loss", "acc", "acc_modal"):
            np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]), *FWD_TOL, err_msg=f"step {t} {key}")
        for f in FIELDS:
            got, want = getattr(trainer.ctrl, f).numpy(), np.asarray(getattr(state.controller, f))
            assert got.dtype == want.dtype, f
            if f in ("M_main", "M_bypass", "d_BDR"):
                np.testing.assert_allclose(got, want, rtol=BDR_RTOL, err_msg=f"step {t} {f}")
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"step {t} {f}")
        modes.append(bool(state.controller.curation_mode))

        after, got = state_dict_from_jax(state.params, state.batch_stats, state.mmtm), port.state_dict()
        for key, want in after.items():
            if key in {n for n, _ in port.named_parameters()}:
                err = float((got[key] - want).norm())
                assert err <= UPDATE_TOL * float((want - before[key]).norm()) + 1e-7, (t, key, err)
            else:  # BatchNorm statistics, MMTM running averages and step
                np.testing.assert_allclose(got[key].numpy(), want.numpy(), *FWD_TOL, err_msg=f"step {t} {key}")
    assert modes == [True, True, False]  # entered after step 1, counted down, left after step 3


def test_sgd_matches_make_optimizer():
    """``torch.optim.SGD(lr, momentum, weight_decay)`` and the JAX package's
    optax chain (``train_state.py:39-52``) on the same gradients: decay
    added to the gradient, the momentum trace (first step = gradient), the
    lr step; and the learning rate changed between steps."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    opt = jax_make_optimizer(lr=0.1, momentum=0.9, weight_decay=1e-2)
    jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = make_optimizer([tp], lr=0.1, momentum=0.9, weight_decay=1e-2)
    for i, g in enumerate(grads):
        if i == 2:
            js.hyperparams["learning_rate"] = jnp.asarray(0.03)
            for group in topt.param_groups:
                group["lr"] = 0.03
        upd, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7, err_msg=f"step {i}")
