"""Both model families at bfloat16 compute against the JAX package on the
same weights and uint8 batches, on the CPU: ``MMTM_MVCNN`` as
``configs/tpu_bf16.gin`` sets it (2 views, 8 classes) and ``MMTM_3DCNN``
with ``compute_dtype='bfloat16'`` (3 modalities, width 0.25, 4 frames, 4
classes); parameters and statistics stay float32 in both.

* The eval forward (2-D at 64², 3-D at 16²; B=4 with a padded row): the
  blended logits within ``BLEND_ULPS`` bf16 ulps of the largest |blend|, and
  the same argmax.
* One guided train step (2-D at 64², 3-D at 32²): bf16 rounding alone
  moves either package's update by 30-40% of the update from its own f32
  step, so the port's bf16 update must lie within ``STEP_FACTOR`` times the
  larger of those two distances of the JAX package's; the loss within
  ``LOSS_RTOL``; BatchNorm statistics within ``STAT_TOL`` of their largest
  magnitude."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.data.transforms import preprocess as jax_preprocess
from greedy_multimodal_learning_tpu.engine import build_train_step, create_train_state
from greedy_multimodal_learning_tpu.engine import controller as jax_ctrl
from greedy_multimodal_learning_tpu.engine import make_optimizer as jax_make_optimizer
from greedy_multimodal_learning_tpu.engine.bdr import GroupReducer as JaxGroupReducer
from greedy_multimodal_learning_tpu.models import MMTM3DCNN as JaxMMTM3DCNN
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.data.transforms import preprocess
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.models import build_3dcnn_from_config, build_model_from_config

B = 4
MASK = np.array([1, 1, 1, 0], np.float32)  # row 3 is padding
LR = 0.05
# Eval blend: both packages round every layer's output to bf16 (8 significant
# bits) in another order; measured 1.9 ulps on the 2-D family at 64² and 0.5
# on the 3-D family.
BLEND_ULPS = 4
# Train step: ||port - jax|| <= STEP_FACTOR * max(||jax_bf16 - jax_f32||,
# ||port_bf16 - port_f32||) over all parameters (measured 0.32-0.41 against
# 0.30-0.43); a wrong term in the bf16 path would add to the f32 distance.
STEP_FACTOR = 1.5
LOSS_RTOL = 4e-3  # the loss is f32 over bf16 logits (2^-8 relative each)
STAT_TOL = 0.1  # running statistics of bf16 activations, relative to the largest


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps the small convolutions from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FAMILIES = {
    # family: (port bindings, JAX model by dtype, port build function, eval and train batch shapes, classes,
    # BDR groups).  The train steps run where layer group 4's maps hold 2x2
    # positions: at 1x1 the masked batch statistics of 3 rows amplify the
    # rounding (tests/test_torch_models_3d.py), and in bf16 the 2-D step then
    # moves farther from its f32 step than the update itself.
    "MMTM_MVCNN": (["MMTM_MVCNN.nclasses = 8", "MMTM_MVCNN.compute_dtype = 'bfloat16'"],
                   lambda dtype: JaxMMTMMVCNN(nclasses=8, dtype=dtype), build_model_from_config,
                   ((B, 2, 64, 64, 3), (B, 2, 64, 64, 3)), 8,
                   (["net_view_0", "net_view_1"], ["visual", "skeleton"])),
    "MMTM_3DCNN": (["MMTM_3DCNN.nclasses = 4", "MMTM_3DCNN.width_multiplier = 0.25",
                    "MMTM_3DCNN.compute_dtype = 'bfloat16'"],
                   lambda dtype: JaxMMTM3DCNN(nclasses=4, num_towers=3, width_multiplier=0.25, dtype=dtype),
                   build_3dcnn_from_config, ((B, 3, 4, 16, 16, 3), (B, 3, 4, 32, 32, 3)), 4,
                   (["net_view_0", "net_view_1", "net_view_2"], ["rgb", "depth", "flow"])),
}


def _port_model(family, dtype):
    """The family built from its gin scope (bf16 from the binding), on the
    CPU in its memory format."""
    bindings, _, build, _, _, _ = FAMILIES[family]
    port_cfg.clear_config()
    port_cfg.parse_config("\n".join(bindings))
    try:
        model = build(dtype)
    finally:
        port_cfg.clear_config()
    return model.to(memory_format=model.memory_format)


def _ulp(x):
    """The bf16 spacing at |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_eval_forward_matches_jax(family):
    _, jax_model, _, (shape, _), _, _ = FAMILIES[family]
    model = _port_model(family, None)
    assert model.dtype == torch.bfloat16
    images = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    jmodel = jax_model(jnp.bfloat16)
    state = create_train_state(jmodel, None, jax.random.PRNGKey(1), jnp.zeros(shape), num_modalities=shape[1])
    model.load_state_dict(state_dict_from_jax(state.params, state.batch_stats, state.mmtm), strict=False)
    x = jax_preprocess(jnp.asarray(images), train=False, dtype=jnp.bfloat16)
    (want, _, _, _), _ = jmodel.apply({"params": state.params, "batch_stats": state.batch_stats, "mmtm": state.mmtm},
                                      x, train=False, valid_mask=jnp.asarray(MASK), mutable=["mmtm"])
    with torch.no_grad():
        got, _, _, _ = model(preprocess(torch.from_numpy(images), train=False, dtype=torch.bfloat16),
                             valid_mask=torch.from_numpy(MASK), mmtm_state={})
    want, got = np.asarray(want, np.float32), got.float().numpy()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= BLEND_ULPS * _ulp(scale), (err, scale, err / _ulp(scale))
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def _step(family, bf16):
    """One guided step of each package from the same f32 state and batch at
    the given compute dtype; returns (state before, JAX after, port after,
    parameter names, JAX loss, port loss)."""
    _, jax_model, _, (_, shape), nclasses, (branches, names) = FAMILIES[family]
    model = _port_model(family, torch.bfloat16 if bf16 else torch.float32)
    jmodel = jax_model(jnp.bfloat16 if bf16 else jnp.float32)
    opt = jax_make_optimizer(lr=LR)
    state = create_train_state(jmodel, opt, jax.random.PRNGKey(1), jnp.zeros(shape), num_modalities=shape[1])
    before = state_dict_from_jax(state.params, state.batch_stats, state.mmtm)
    model.load_state_dict(before, strict=False)
    update = functools.partial(jax_ctrl.guided_update, epsilon=1e-3, curation_windowsize=3)
    step = build_train_step(jmodel, opt, JaxGroupReducer(state.params, branches, names), update, donate=False)
    config = {"epsilon": 1e-3, "curation_windowsize": 3, "branchnames": branches, "mmtm_names": names}
    trainer = Trainer(model, make_optimizer(model.parameters(), lr=LR), controller_kind="guided",
                      controller_config=config, nummodalities=shape[1], device="cpu")
    rng = np.random.default_rng(2)
    batch = {"images": rng.integers(0, 256, shape, dtype=np.uint8),
             "labels": rng.integers(0, nclasses, B).astype(np.int32), "mask": MASK}
    flip_shape = (B,) if len(shape) == 6 else (B, shape[1])
    flips = np.asarray(jax.random.bernoulli(jax.random.fold_in(state.rng, state.step), 0.5, flip_shape))
    new_state, j_out = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(True))
    t_out = trainer.train_batch({k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(flips),
                                torch.tensor(True))
    after = state_dict_from_jax(new_state.params, new_state.batch_stats, new_state.mmtm)
    port = {k: v.float() for k, v in model.state_dict().items() if k in after}
    return before, after, port, [n for n, _ in model.named_parameters()], float(j_out["loss"]), float(t_out["loss"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_train_step_matches_jax(family):
    before, j16, t16, params, j_loss, t_loss = _step(family, bf16=True)
    _, j32, t32, _, _, _ = _step(family, bf16=False)

    def distance(a, b):
        return sum(float((a[k] - b[k]).norm()) ** 2 for k in params) ** 0.5

    floor = max(distance(j16, j32), distance(t16, t32))
    assert floor < 0.6 * distance(j32, before)  # the f32 and bf16 steps move the same way
    assert distance(t16, j16) <= STEP_FACTOR * floor, (distance(t16, j16), floor)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    for key, want in j16.items():
        if key.endswith(("running_mean", "running_var")):
            assert float((t16[key] - want).abs().max()) <= STAT_TOL * float(want.abs().max()), key
