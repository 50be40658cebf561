"""The port's two-tower MMTM model against the JAX package's on the same
weights: eval forward at B=4, 64² (the size of tests/test_torch_parity.py),
on both gating paths; and the same weights loaded from a ``.pt`` file that
the JAX package's ``save_weights`` wrote."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.engine import create_train_state
from greedy_multimodal_learning_tpu.engine.checkpoint import save_weights
from greedy_multimodal_learning_tpu.models import MMTMMVCNN as JaxMMTMMVCNN
from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.engine.checkpoint import load_weights, state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN

B, IMG, NC = 4, 64, 8
RTOL, ATOL = 5e-3, 5e-4  # the logits tolerance of tests/test_torch_parity.py:163
MASK = np.array([1, 1, 1, 0], np.float32)


@pytest.fixture(scope="module")
def jax_state():
    model = JaxMMTMMVCNN(nclasses=NC, use_pallas=True)
    x = np.random.default_rng(0).normal(size=(B, 2, IMG, IMG, 3)).astype(np.float32)
    state = create_train_state(model, None, jax.random.PRNGKey(1), jnp.asarray(x))
    return state, x


def _port_model(state, use_pallas):
    model = MMTMMVCNN(nclasses=NC, use_pallas=use_pallas)
    missing, unexpected = model.load_state_dict(
        state_dict_from_jax(state.params, state.batch_stats, state.mmtm), strict=False
    )
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    assert not unexpected, unexpected
    return model.to(memory_format=torch.channels_last).eval()


def _port_forward(model, x):
    with torch.no_grad():
        blend, logits, _, _ = model(torch.from_numpy(x), valid_mask=torch.from_numpy(MASK), mmtm_state={})
    return blend, logits


@pytest.mark.parametrize("use_pallas", [True, False])
def test_eval_forward_matches_jax(jax_state, use_pallas):
    state, x = jax_state
    jax_model = JaxMMTMMVCNN(nclasses=NC, use_pallas=use_pallas)
    (j_blend, j_logits, _, _), _ = jax_model.apply(
        {"params": state.params, "batch_stats": state.batch_stats, "mmtm": state.mmtm},
        jnp.asarray(x),
        train=False,
        valid_mask=jnp.asarray(MASK),
        mutable=["mmtm"],
    )
    blend, logits = _port_forward(_port_model(state, use_pallas), x)
    for v in range(2):
        np.testing.assert_allclose(logits[v].numpy(), np.asarray(j_logits[v]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(blend.numpy(), np.asarray(j_blend), rtol=RTOL, atol=ATOL)


def test_jax_written_checkpoint_loads_identically(jax_state, tmp_path):
    state, x = jax_state
    path = str(tmp_path / "model.pt")
    save_weights(state, path)
    bridged = _port_model(state, True)
    loaded = init_model(MMTMMVCNN(nclasses=NC, use_pallas=True), 123, "cpu")
    load_weights(loaded, path)
    a_blend, a_logits = _port_forward(bridged, x)
    b_blend, b_logits = _port_forward(loaded, x)
    assert torch.equal(a_blend, b_blend)
    for a, b in zip(a_logits, b_logits):
        assert torch.equal(a, b)
