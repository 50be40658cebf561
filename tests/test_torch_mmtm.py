"""The port's MMTM module against the JAX package's under the same weights:
outputs, gates, squeezes and the running-average state, on the eager and
the fused-kernel gating paths (the JAX kernel in interpret mode, the port's
plain version on CPU tensors)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.models import MMTM as JaxMMTM
from greedy_multimodal_learning_tpu_torch.engine.checkpoint import state_dict_from_jax
from greedy_multimodal_learning_tpu_torch.models import MMTM

B, H, W, C = 6, 3, 3, 16
RTOL, ATOL = 2e-5, 1e-5  # f32, as tests/test_pallas_ops.py:42
MASK = np.array([1, 1, 0, 1, 1, 1], np.float32)  # row 2 is padding


def _features(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, W, C)).astype(np.float32) for _ in range(2)]


def _pair(use_pallas):
    jm = JaxMMTM(dims=[C, C], use_pallas=use_pallas)
    variables = jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in _features(0)])
    tm = MMTM(dims=[C, C], use_pallas=use_pallas)
    tm.load_state_dict(state_dict_from_jax(variables["params"], {}, variables["mmtm"]), strict=True)
    return jm, variables, tm


def _run_jax(jm, variables, feats, **kw):
    (outs, scales, squeezes), mut = jm.apply(
        variables,
        [jnp.asarray(f) for f in feats],
        valid_mask=jnp.asarray(MASK),
        return_scale=True,
        return_squeezed_mps=True,
        mutable=["mmtm"],
        **kw,
    )
    return [np.asarray(o) for o in outs], scales, squeezes, mut["mmtm"]


def _run_torch(tm, feats, state_out=None, **kw):
    x = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]  # NCHW in channels-last memory
    with torch.no_grad():
        outs, scales, squeezes = tm(
            x, valid_mask=torch.from_numpy(MASK), return_scale=True, return_squeezed_mps=True,
            state_out=state_out, **kw,
        )
    return [o.permute(0, 2, 3, 1).numpy() for o in outs], scales, squeezes


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _compare(torch_res, jax_res):
    (t_outs, t_scales, t_sq), (j_outs, j_scales, j_sq, _) = torch_res, jax_res
    for i in range(2):
        _close(t_outs[i], j_outs[i], f"out{i}")
        _close(t_scales[i], j_scales[i], f"gate{i}")
        _close(t_sq[i], j_sq[i], f"squeeze{i}")


def _compare_state(state, jax_state):
    for name in ("running_avg_visual", "running_avg_skeleton", "step"):
        _close(state[name], jax_state[name], name)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_masked_forward_matches_jax(use_pallas):
    jm, variables, tm = _pair(use_pallas)
    feats = _features(1)
    jax_res = _run_jax(jm, variables, feats)
    before = {k: v.clone() for k, v in tm.named_buffers()}
    state = {}
    _compare(_run_torch(tm, feats, state_out=state), jax_res)
    _compare_state(state, jax_res[3])
    # with state_out the module's buffers stay as they were
    for k, v in tm.named_buffers():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("use_pallas", [True, False])
def test_consecutive_calls_update_running_state(use_pallas):
    """Two forwards: running averages (bug_compat: both from the first
    modality's masked gate mean) and step follow the JAX package."""
    jm, variables, tm = _pair(use_pallas)
    for call in (1, 2):
        feats = _features(call)
        jax_res = _run_jax(jm, variables, feats)
        _compare(_run_torch(tm, feats), jax_res)
        _compare_state(dict(tm.named_buffers()), jax_res[3])
        variables = {**variables, "mmtm": jax_res[3]}
    assert float(tm.step) == 2.0
    assert torch.equal(tm.running_avg_visual, tm.running_avg_skeleton)  # bug_compat


@pytest.mark.parametrize("caring_modality", [0, 1])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_curation_matches_jax(use_pallas, caring_modality):
    """Curation: the cared-for modality is scaled by the post-update running
    average, the other by its live gate."""
    jm, variables, tm = _pair(use_pallas)
    warm = _features(1)
    variables = {**variables, "mmtm": _run_jax(jm, variables, warm)[3]}
    _run_torch(tm, warm)
    feats = _features(2)
    jax_res = _run_jax(
        jm, variables, feats, curation_mode=jnp.asarray(True), caring_modality=jnp.asarray(caring_modality, jnp.int32)
    )
    torch_res = _run_torch(
        tm, feats, curation_mode=torch.tensor(True), caring_modality=torch.tensor(caring_modality)
    )
    _compare(torch_res, jax_res)
    _compare_state(dict(tm.named_buffers()), jax_res[3])
    # the cared-for output really used the running average, not the live gate
    cared = torch_res[0][caring_modality]
    live = feats[caring_modality] * np.asarray(jax_res[1][caring_modality])[:, None, None, :]
    assert not np.allclose(cared, live, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_flow_off_matches_jax(use_pallas):
    """``turnoff_cross_modal_flow``: each modality's gate sees its own live
    squeeze and the other's dataset average; the branch comes before the
    kernel branch in both packages, so ``use_pallas`` changes nothing."""
    jm, variables, tm = _pair(use_pallas)
    rng = np.random.default_rng(7)
    avg = [np.abs(rng.normal(size=(C,))).astype(np.float32) for _ in range(2)]
    feats = _features(3)
    jax_res = _run_jax(jm, variables, feats, turnoff_cross_modal_flow=True,
                       average_squeezemaps=[jnp.asarray(a) for a in avg])
    state = {}
    torch_res = _run_torch(tm, feats, state_out=state, turnoff_cross_modal_flow=True,
                           average_squeezemaps=[torch.from_numpy(a) for a in avg])
    _compare(torch_res, jax_res)
    _compare_state(state, jax_res[3])
    # the gates differ from the flow-on forward's
    flow_on = _run_torch(tm, feats, state_out={})
    assert not np.allclose(np.asarray(torch_res[1][0]), np.asarray(flow_on[1][0]), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="average_squeezemaps"):
        _run_torch(tm, feats, state_out={}, turnoff_cross_modal_flow=True)


@pytest.mark.parametrize("variant", [dict(SEonly=True), dict(shareweight=True), dict(SEonly=True, shareweight=True)],
                         ids=["SEonly", "shareweight", "SEonly_shareweight"])
def test_variants_build_with_the_jax_names(variant):
    """``SEonly`` and ``shareweight`` build, and their state_dict keys are the
    ones ``state_dict_from_jax`` gives the JAX module's variables (a strict
    load); ``tests/test_torch_options.py`` runs them against the JAX module."""
    jm = JaxMMTM(dims=[C, C], **variant)
    variables = jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in _features(0)])
    want = state_dict_from_jax(variables["params"], {}, variables["mmtm"])
    tm = MMTM(dims=[C, C], **variant)
    assert sorted(tm.state_dict()) == sorted(want)
    tm.load_state_dict(want, strict=True)
