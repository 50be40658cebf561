"""Fused MMTM gating forward: the CUDA kernel, its plain PyTorch version,
and the wrapper that picks between them by device.

Replaces the Pallas TPU kernel ``_gating_kernel``
(``greedy_multimodal_learning_tpu/ops/mmtm_pallas.py:47-78``, launched by
``_fused_forward`` at :95-147 and bound as ``fused_mmtm_gating``).  The
kernel is ``csrc/mmtm_gating.cu``; its header says what bounds it on an
H100 (memory: one read and one write of both feature maps) and how its four
passes stand against that bound.

Layouts follow the JAX kernel's features and torch's weights: ``f0``, ``f1``
are contiguous (B, S, C) maps (a ``channels_last`` NCHW map permuted to
NHWC and flattened is such a view), ``wsq`` (D, 2C) and ``w_i`` (C, D) are
``nn.Linear`` weights in their own (out, in) layout, read in place.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The row-product passes stage a tile of 8 samples' inputs in static-size
# shared memory (48 KB without an opt-in).
_MAX_ROW_INPUT = 48 * 1024 // (8 * 4)


def mmtm_gating_plain(f0, f1, wsq, bsq, w0, b0, w1, b1):
    """Plain PyTorch version with the kernel's rounding points
    (``mmtm_pallas.py:52-71``): squeeze in f32, the joint squeeze and the
    excitation rounded to the weights' dtype before each product, products
    accumulated in f32, biases added in f32, the gate rounded to the
    features' dtype before the scale.  Returns (out0, out1, sq0, sq1, g0, g1)."""
    sq0 = f0.mean(dim=1, dtype=torch.float32)
    sq1 = f1.mean(dim=1, dtype=torch.float32)
    joint = torch.cat([sq0, sq1], dim=1).to(wsq.dtype).float()
    e = torch.relu(joint @ wsq.float().t() + bsq.float())
    g0 = torch.sigmoid(e.to(w0.dtype).float() @ w0.float().t() + b0.float())
    g1 = torch.sigmoid(e.to(w1.dtype).float() @ w1.float().t() + b1.float())
    out0 = f0 * g0[:, None, :].to(f0.dtype)
    out1 = f1 * g1[:, None, :].to(f1.dtype)
    return out0, out1, sq0, sq1, g0, g1


def _check(f0, f1, wsq, bsq, w0, b0, w1, b1):
    if f0.dim() != 3 or f0.shape != f1.shape:
        raise ValueError(f"f0 and f1 must be (B, S, C) of one shape, got {tuple(f0.shape)} and {tuple(f1.shape)}")
    B, S, C = f0.shape
    if B < 1 or S < 1 or C < 1:
        raise ValueError(f"empty feature map {tuple(f0.shape)}")
    D = wsq.shape[0]
    expected = {
        "wsq": (wsq, (D, 2 * C)), "bsq": (bsq, (D,)),
        "w0": (w0, (C, D)), "b0": (b0, (C,)),
        "w1": (w1, (C, D)), "b1": (b1, (C,)),
    }
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape} for C={C}, D={D}; got {tuple(t.shape)}")
    tensors = {"f0": f0, "f1": f1, **{k: v[0] for k, v in expected.items()}}
    for name, t in tensors.items():
        if t.device != f0.device:
            raise ValueError(f"{name} is on {t.device}, f0 on {f0.device}")
        if t.dtype != f0.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, the features {f0.dtype}: cast the weights to the compute dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (no copy is made); got strides {t.stride()}")
    if f0.dtype not in _DTYPE_CODES:
        raise TypeError(f"mmtm_gating supports float32 and bfloat16, got {f0.dtype}")
    return B, S, C, D


def mmtm_gating(f0, f1, wsq, bsq, w0, b0, w1, b1):
    """Fused MMTM gating forward.  Returns (out0, out1, sq0, sq1, g0, g1):
    out_i in the features' dtype, sq_i and g_i (B, C) float32.

    On CPU tensors it runs :func:`mmtm_gating_plain`; on CUDA tensors it
    launches the kernel (building it at first use) or raises.  Each kernel
    launch adds one to ``mmtm_gating.launches``."""
    B, S, C, D = _check(f0, f1, wsq, bsq, w0, b0, w1, b1)
    if f0.device.type == "cpu":
        return mmtm_gating_plain(f0, f1, wsq, bsq, w0, b0, w1, b1)
    if f0.device.type != "cuda":
        raise ValueError(f"mmtm_gating runs on CPU or CUDA tensors, got {f0.device}")
    if C % 8:
        raise ValueError(f"the CUDA kernel needs C % 8 == 0 (16-byte vectors), got C={C}")
    if B > 65535:
        raise ValueError(f"the CUDA kernel's squeeze grid takes B up to 65535, got {B}")
    if max(2 * C, D) > _MAX_ROW_INPUT:
        raise ValueError(f"the CUDA kernel supports 2C and D up to {_MAX_ROW_INPUT}, got C={C}, D={D}")
    for name, t in (("f0", f0), ("f1", f1)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads")

    out0 = torch.empty_like(f0)
    out1 = torch.empty_like(f1)
    rows = lambda n: torch.empty((B, n), dtype=torch.float32, device=f0.device)
    sq0, sq1, g0, g1, e = rows(C), rows(C), rows(C), rows(C), rows(D)

    lib = _library()
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream(f0.device).cuda_stream
        err = lib.mmtm_gating_forward(
            *(t.data_ptr() for t in (f0, f1, wsq, bsq, w0, b0, w1, b1, out0, out1, sq0, sq1, e, g0, g1)),
            B, S, C, D, _DTYPE_CODES[f0.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"mmtm_gating_forward launch failed: CUDA error {err}")
    mmtm_gating.launches += 1
    return out0, out1, sq0, sq1, g0, g1


mmtm_gating.launches = 0


def _library():
    lib = load("mmtm_gating")
    fn = lib.mmtm_gating_forward
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib
