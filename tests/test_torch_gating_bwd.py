"""The port's fused MMTM gating backward (plain version, which CPU tensors
take) and its autograd Function against ``jax.grad`` through the JAX
package's ``fused_mmtm_gating`` (Pallas kernels in interpret mode), with
cotangents on out, sq and g; plus f32 agreement with torch autograd of the
eager gating, and the wrapper's checks."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.ops import fused_mmtm_gating
from greedy_multimodal_learning_tpu_torch.ops.mmtm_gating import (
    MMTMGatingFunction,
    mmtm_gating,
    mmtm_gating_bwd,
    mmtm_gating_bwd_plain,
    mmtm_gating_plain,
)

S, C, D = 10, 16, 16
NAMES = ("df0", "df1", "dwsq", "dbsq", "dw0", "db0", "dw1", "db1")

# (rtol, atol).  f32: the same f32 arithmetic in another summation order
# (the tolerance of tests/test_pallas_ops.py:42).  bf16: df and every weight
# gradient are rounded to bf16 on both sides, so they may differ by one bf16
# ulp (2^-7 relative) where the f32 values straddle a rounding boundary.
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (8e-3, 1e-6)}


def _arrays(batch, seed=0):
    """numpy inputs as tests/test_pallas_ops.py draws them (JAX layout:
    Wsq (2C, D), W_i (D, C)) and the cotangents of the six outputs."""
    rng = np.random.default_rng(seed)
    ins = [
        rng.normal(size=(batch, S, C)),
        rng.normal(size=(batch, S, C)),
        rng.normal(size=(2 * C, D)) * 0.2,
        rng.normal(size=(D,)) * 0.1,
        rng.normal(size=(D, C)) * 0.2,
        rng.normal(size=(C,)) * 0.1,
        rng.normal(size=(D, C)) * 0.2,
        rng.normal(size=(C,)) * 0.1,
    ]
    cots = [rng.normal(size=(batch, S, C)), rng.normal(size=(batch, S, C))] + [
        rng.normal(size=(batch, C)) for _ in range(4)
    ]
    return [a.astype(np.float32) for a in ins], [a.astype(np.float32) for a in cots]


def _to_torch(ins, dtype):
    """Rounded to ``dtype`` (so both sides see identical values), weights in
    nn.Linear's (out, in) layout."""
    t = [torch.from_numpy(a).to(dtype) for a in ins]
    for i in (2, 4, 6):
        t[i] = t[i].t().contiguous()
    return t


def _jax_grads(ins, cots, dtype):
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()).astype(jdt) for a in ins]
    c_out = [jnp.asarray(c).astype(jdt) for c in cots[:2]]
    c_rows = [jnp.asarray(c) for c in cots[2:]]  # on sq0, sq1, g0, g1 (float32 outputs)

    def loss(*a):
        out0, out1, sq0, sq1, g0, g1 = fused_mmtm_gating(*a, 4, True)
        total = jnp.sum((out0 * c_out[0]).astype(jnp.float32)) + jnp.sum((out1 * c_out[1]).astype(jnp.float32))
        for r, c in zip((sq0, sq1, g0, g1), c_rows):
            total = total + jnp.sum(r * c)
        return total

    grads = jax.grad(loss, argnums=tuple(range(8)))(*args)
    df0, df1, dwsq, dbsq, dw0, db0, dw1, db1 = grads
    # -> the port's order and weight layout
    return [df0, df1, dwsq.T, dbsq, dw0.T, db0, dw1.T, db1]


def _close(got, want, dtype, what):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32)), rtol=rtol, atol=atol,
        err_msg=what,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [8, 5])  # 5 is ragged against the kernel's 8-sample tiles
def test_function_matches_jax_grad(batch, dtype):
    ins, cots = _arrays(batch)
    tdt = getattr(torch, dtype)
    args = [t.requires_grad_() for t in _to_torch(ins, tdt)]
    outs = MMTMGatingFunction.apply(*args)
    grad_outs = [torch.from_numpy(c).to(tdt) for c in cots[:2]] + [torch.from_numpy(c) for c in cots[2:]]
    torch.autograd.backward(outs, grad_outs)
    want = _jax_grads(ins, cots, dtype)
    for name, t, w in zip(NAMES, args, want):
        assert t.grad.dtype == tdt, f"{name}: {t.grad.dtype}"  # bf16 bias grads come back in bf16
        _close(t.grad, w, dtype, name)


@pytest.mark.parametrize("batch", [8, 5])
def test_plain_backward_matches_jax_grad(batch):
    ins, cots = _arrays(batch, seed=1)
    f0, f1, wsq, bsq, w0, b0, w1, b1 = _to_torch(ins, torch.float32)
    _, _, sq0, sq1, g0, g1 = mmtm_gating_plain(f0, f1, wsq, bsq, w0, b0, w1, b1)
    do0, do1, dsq0, dsq1, dg0, dg1 = [torch.from_numpy(c) for c in cots]
    got = mmtm_gating_bwd_plain(do0, do1, f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1, dg0, dg1, dsq0, dsq1)
    for name, g, w in zip(NAMES, got, _jax_grads(ins, cots, "float32")):
        assert g.dtype == torch.float32, name
        _close(g, w, "float32", name)


@pytest.mark.parametrize("used", ["all", "out_only", "g_only"])
def test_function_matches_autograd_of_eager_gating_f32(used):
    """In f32 the eager gating (torch autograd through mmtm_gating_plain,
    which is the eager arithmetic when nothing rounds) and the fused
    backward agree; unused outputs reach the backward as None."""
    ins, cots = _arrays(6, seed=2)
    keep = {"all": range(6), "out_only": (0, 1), "g_only": (4, 5)}[used]
    grads = []
    for fn in (MMTMGatingFunction.apply, mmtm_gating_plain):
        args = [t.requires_grad_() for t in _to_torch(ins, torch.float32)]
        outs = fn(*args)
        loss = sum((outs[i] * torch.from_numpy(cots[i])).sum() for i in keep)
        loss.backward()
        grads.append([a.grad for a in args])
    for name, g, w in zip(NAMES, *grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5, atol=1e-5, err_msg=name)


def test_cpu_backward_takes_plain_version_without_counting():
    ins, cots = _arrays(4)
    f0, f1, wsq, bsq, w0, b0, w1, b1 = _to_torch(ins, torch.float32)
    _, _, sq0, sq1, g0, g1 = mmtm_gating(f0, f1, wsq, bsq, w0, b0, w1, b1)
    do0, do1 = torch.from_numpy(cots[0]), torch.from_numpy(cots[1])
    mmtm_gating_bwd.launches = 0
    got = mmtm_gating_bwd(do0, do1, f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1)
    want = mmtm_gating_bwd_plain(do0, do1, f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert mmtm_gating_bwd.launches == 0


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    ins, cots = _arrays(4)
    f0, f1, wsq, bsq, w0, b0, w1, b1 = _to_torch(ins, torch.float32)
    _, _, sq0, sq1, g0, g1 = mmtm_gating(f0, f1, wsq, bsq, w0, b0, w1, b1)
    do0, do1 = torch.from_numpy(cots[0]), torch.from_numpy(cots[1])
    rest = (f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1)
    with pytest.raises(ValueError, match="do0"):
        mmtm_gating_bwd(do0.bfloat16(), do1, *rest)
    with pytest.raises(ValueError, match="do1"):
        mmtm_gating_bwd(do0, do1.transpose(1, 2).contiguous().transpose(1, 2), *rest)
    with pytest.raises(ValueError, match="dg0c"):
        mmtm_gating_bwd(do0, do1, *rest, dg0c=g0.double())
    with pytest.raises(ValueError, match="shape"):
        mmtm_gating_bwd(do0, do1, f0, f1, g0, g1, sq0, sq1, wsq[:, :-1].contiguous(), bsq, w0, w1)
