"""Pieces of the port's train step against the JAX package's: masked
train-mode BatchNorm (outputs and running statistics), the guided
controller over a scripted (gn, wn, unlock) sequence, the BDR group sums,
train-time flips and the loss and metrics."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.data.transforms import preprocess as jax_preprocess
from greedy_multimodal_learning_tpu.engine import create_train_state
from greedy_multimodal_learning_tpu.engine.bdr import GroupReducer as JaxGroupReducer
from greedy_multimodal_learning_tpu.engine.controller import guided_update as jax_guided_update
from greedy_multimodal_learning_tpu.engine.controller import init_controller_state as jax_init_controller
from greedy_multimodal_learning_tpu.engine.metrics import blend_and_per_view_acc as jax_accs
from greedy_multimodal_learning_tpu.engine.metrics import blend_loss as jax_blend_loss
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu.models.layers import TorchBatchNorm
from greedy_multimodal_learning_tpu_torch.data.transforms import preprocess
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.engine.bdr import GroupReducer
from greedy_multimodal_learning_tpu_torch.engine.controller import guided_update, init_controller_state
from greedy_multimodal_learning_tpu_torch.engine.metrics import blend_and_per_view_acc, blend_loss
from greedy_multimodal_learning_tpu_torch.models import BatchNorm2d, MMTMMVCNN
from greedy_multimodal_learning_tpu_torch.utils import prng

B, H, W, C = 6, 5, 4, 8
MASK = np.array([1, 1, 1, 0, 1, 1], np.float32)  # row 3 is padding
RTOL, ATOL = 2e-5, 1e-5  # f32: the same arithmetic in another summation order


def _bn_pair(seed=0):
    rng = np.random.default_rng(seed)
    scale, bias = rng.uniform(0.5, 1.5, C).astype(np.float32), rng.normal(size=C).astype(np.float32)
    mean, var = rng.normal(size=C).astype(np.float32), rng.uniform(0.5, 2.0, C).astype(np.float32)
    jvars = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    bn = BatchNorm2d(C)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean), "running_var": torch.from_numpy(var)}, strict=False)
    return jvars, bn


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_train_batchnorm_matches_jax(masked, dtype):
    jvars, bn = _bn_pair()
    x = (3.0 * np.random.default_rng(1).normal(size=(B, H, W, C)) + 1.0).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()  # both sides see the same values
    mask = MASK if masked else None
    y, mut = TorchBatchNorm(dtype=jnp.dtype(dtype)).apply(
        jvars, jnp.asarray(x).astype(jnp.dtype(dtype)), use_running_average=False,
        mask=None if mask is None else jnp.asarray(mask), mutable=["batch_stats"],
    )
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)  # NCHW in channels-last memory
    got = bn(xt, train=True, mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype)
    # bf16 output: one bf16 ulp (2^-7 relative) where f32 values straddle a rounding boundary
    rtol = RTOL if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(), np.asarray(y.astype(jnp.float32)),
                               rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), rtol=RTOL, atol=ATOL)


def test_eval_batchnorm_leaves_statistics():
    jvars, bn = _bn_pair()
    x = np.random.default_rng(2).normal(size=(B, H, W, C)).astype(np.float32)
    y = TorchBatchNorm().apply(jvars, jnp.asarray(x), use_running_average=True)
    before = bn.running_mean.clone()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2), train=False, mask=torch.from_numpy(MASK))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), rtol=RTOL, atol=ATOL)
    assert torch.equal(bn.running_mean, before)


FIELDS = ("M_main", "M_bypass", "curation_mode", "caring_modality", "curation_step", "d_BDR")


def _script(n, steps, seed, equal_ratios=False):
    rng = np.random.default_rng(seed)
    gn = rng.lognormal(size=(steps, 2 * n)).astype(np.float32)
    wn = rng.lognormal(size=(steps, 2 * n)).astype(np.float32)
    if equal_ratios:  # every group's ratio equal: d_BDR stays 0, curation never starts
        gn[:] = 2.0
        wn[:] = 4.0
    unlock = np.array([False, False] + [True] * (steps - 2))
    return gn, wn, unlock


@pytest.mark.parametrize("n, seed, equal", [(2, 0, False), (2, 1, False), (2, 2, True), (3, 3, False)])
def test_guided_update_matches_jax_field_by_field(n, seed, equal):
    """Every ControllerState field at every step of a scripted sequence:
    locked steps, entering a window, counting it down, leaving it."""
    window, eps = 3, 0.01
    gn, wn, unlock = _script(n, 14, seed, equal)
    js, ts = jax_init_controller(n), init_controller_state(n)
    ju = jax.jit(functools.partial(jax_guided_update, epsilon=eps, curation_windowsize=window))
    seen = set()
    for t in range(len(gn)):
        js = ju(js, jnp.asarray(gn[t]), jnp.asarray(wn[t]), jnp.asarray(unlock[t]))
        ts = guided_update(ts, torch.from_numpy(gn[t]), torch.from_numpy(wn[t]), torch.tensor(bool(unlock[t])),
                           epsilon=eps, curation_windowsize=window)
        for f in FIELDS:
            want, got = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            assert got.dtype == want.dtype, (t, f, got.dtype, want.dtype)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f"step {t} {f}")
        seen.add((bool(ts.curation_mode), int(ts.curation_step)))
    if equal:
        assert seen == {(False, 0)}
    else:  # the sequence entered, counted down and left a window
        assert {(True, 0), (True, 2), (False, 3)} <= seen, seen


@pytest.fixture(scope="module")
def jax_params():
    model = JaxMMTMMVCNN(nclasses=4)
    return create_train_state(model, None, jax.random.PRNGKey(3), jnp.zeros((2, 2, 32, 32, 3)))


def test_bdr_group_sums_match_jax(jax_params):
    state = jax_params
    model = MMTMMVCNN(nclasses=4)
    model.load_state_dict(state_dict_from_jax(state.params, state.batch_stats, state.mmtm), strict=False)
    names, tensors = zip(*model.named_parameters())
    got = GroupReducer(names, ["net_view_0", "net_view_1"], ["visual", "skeleton"])(tensors)
    want = JaxGroupReducer(state.params, ["net_view_0", "net_view_1"], ["visual", "skeleton"])(state.params)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)


def test_guided_trainer_rejects_an_empty_group():
    model = MMTMMVCNN(nclasses=4)
    with pytest.raises(ValueError, match="main:net_view_9"):
        Trainer(model, make_optimizer(model.parameters(), lr=0.1), controller_kind="guided",
                controller_config={"epsilon": 0.01, "curation_windowsize": 5,
                                   "branchnames": ["net_view_0", "net_view_9"]},
                device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_preprocess_matches_jax_flips(dtype):
    images = np.random.default_rng(4).integers(0, 256, (5, 2, 6, 7, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(9)
    want = jax_preprocess(jnp.asarray(images), train=True, rng=key, dtype=jnp.dtype(dtype))
    flips = np.asarray(jax.random.bernoulli(key, 0.5, (5, 2)))
    got = preprocess(torch.from_numpy(images), train=True, flip=torch.from_numpy(flips), dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_draws_flips_from_the_generator_only():
    """The flips come from the PRNG key alone (not torch's global
    generator), and are the JAX package's under that key."""
    images = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 2, 3, 3, 3), dtype=np.uint8))
    a = preprocess(images, train=True, key=prng.PRNGKey(1))
    torch.manual_seed(0)
    b = preprocess(images, train=True, key=prng.PRNGKey(1))
    assert torch.equal(a, b)
    want = jax_preprocess(jnp.asarray(images.numpy()), train=True, rng=jax.random.PRNGKey(1))
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="flip"):
        preprocess(images, train=True)


def test_loss_and_metrics_match_jax():
    rng = np.random.default_rng(5)
    logits = [rng.normal(size=(B, 4)).astype(np.float32) for _ in range(2)]
    labels = rng.integers(0, 4, B).astype(np.int32)
    j_loss = jax_blend_loss([jnp.asarray(l) for l in logits], jnp.asarray(labels), jnp.asarray(MASK))
    j_acc, j_modal = jax_accs([jnp.asarray(l) for l in logits], jnp.asarray(labels), jnp.asarray(MASK))
    t_logits = [torch.from_numpy(l) for l in logits]
    loss = blend_loss(t_logits, torch.from_numpy(labels), torch.from_numpy(MASK))
    acc, modal = blend_and_per_view_acc(t_logits, torch.from_numpy(labels), torch.from_numpy(MASK))
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), rtol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc), rtol=1e-6)
    np.testing.assert_allclose(modal.numpy(), np.asarray(j_modal), rtol=1e-6)
