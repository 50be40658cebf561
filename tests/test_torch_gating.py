"""The port's fused MMTM gating (plain version, which CPU tensors take)
against the JAX package's Pallas kernel in interpret mode, on the shapes of
tests/test_pallas_ops.py, plus the wrapper's checks and launch counter."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.ops import fused_mmtm_gating
from greedy_multimodal_learning_tpu_torch.ops.mmtm_gating import mmtm_gating, mmtm_gating_plain

B, S, C, D = 8, 10, 16, 16

# (rtol, atol) per output.  f32: the tolerance of test_pallas_ops.py:42.
# bf16 (compared in f32): both sides multiply the same bf16 values and sum in
# f32, so sq and g differ only by summation order (a bias added in bf16, or
# a product rounded to bf16, would move g by ~1e-4); out is within one bf16
# ulp (2^-7 relative), in case a gate rounds to bf16 on the other side of a
# boundary.
TOL = {
    "float32": {"out": (2e-5, 1e-5), "sq": (2e-5, 1e-5), "g": (2e-5, 1e-5)},
    "bfloat16": {"out": (8e-3, 0.0), "sq": (1e-5, 1e-6), "g": (0.0, 1e-5)},
}


def _inputs(batch, dtype):
    """numpy inputs as tests/test_pallas_ops.py draws them: features (B, S,
    C), JAX-layout weights Wsq (2C, D), W_i (D, C), rounded to ``dtype``."""
    rng = np.random.default_rng(0)
    arrays = [
        rng.normal(size=(B, S, C)),
        rng.normal(size=(B, S, C)),
        rng.normal(size=(2 * C, D)) * 0.2,
        rng.normal(size=(D,)) * 0.1,
        rng.normal(size=(D, C)) * 0.2,
        rng.normal(size=(C,)) * 0.1,
        rng.normal(size=(D, C)) * 0.2,
        rng.normal(size=(C,)) * 0.1,
    ]
    arrays[0], arrays[1] = arrays[0][:batch], arrays[1][:batch]
    # round through the torch dtype so both sides see identical values
    return [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype)) for a in arrays]


def _torch_args(ts):
    """JAX-layout weights -> nn.Linear (out, in) layout."""
    f0, f1, wsq, bsq, w0, b0, w1, b1 = ts
    return [f0, f1, wsq.t().contiguous(), bsq, w0.t().contiguous(), b0, w1.t().contiguous(), b1]


def _jax_args(ts):
    return [jnp.asarray(t.float().numpy()).astype(jnp.dtype(str(t.dtype)[6:])) for t in ts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [8, 6])
def test_plain_matches_jax_kernel(batch, dtype):
    ts = _inputs(batch, dtype)
    want = fused_mmtm_gating(*_jax_args(ts), 4, True)
    got = mmtm_gating(*_torch_args(ts))
    for label, g, w in zip(("out0", "out1", "sq0", "sq1", "g0", "g1"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape, label
        rtol, atol = TOL[dtype][label[:-1]]
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol, atol=atol, err_msg=label)
    assert got[0].dtype == getattr(torch, dtype) and got[2].dtype == torch.float32


def test_cpu_call_takes_plain_version_without_counting():
    mmtm_gating.launches = 0
    args = _torch_args(_inputs(8, "float32"))
    got = mmtm_gating(*args)
    want = mmtm_gating_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert mmtm_gating.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = _torch_args(_inputs(8, "float32"))
    strided = args[0].transpose(1, 2).contiguous().transpose(1, 2)  # (B, S, C) view, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        mmtm_gating(strided, *args[1:])
    with pytest.raises(TypeError, match="dtype"):
        mmtm_gating(*args[:2], args[2].double(), *args[3:])
    with pytest.raises(ValueError, match="shape"):
        mmtm_gating(*args[:4], args[4][:, :-1].contiguous(), *args[5:])
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        mmtm_gating(*[a.half() for a in args])
