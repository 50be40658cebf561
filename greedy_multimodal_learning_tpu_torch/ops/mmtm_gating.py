"""Fused MMTM gating, forward and backward: the CUDA kernels, their plain
PyTorch versions, the wrappers that pick between them by device, and the
``torch.autograd.Function`` that binds the two.

Replaces the Pallas TPU kernels of
``greedy_multimodal_learning_tpu/ops/mmtm_pallas.py``, bound there as the
``jax.custom_vjp`` ``fused_mmtm_gating`` (:281-388):

* ``_gating_kernel`` (:47-78, launched by ``_fused_forward`` :95-147) by
  :func:`mmtm_gating`, kernel ``csrc/mmtm_gating.cu``;
* ``_gating_bwd_kernel`` (:150-226, launched by ``_fused_backward``
  :229-278) by :func:`mmtm_gating_bwd`, kernel ``csrc/mmtm_gating_bwd.cu``.

Each source's header says what bounds it on an H100 (bytes), how its
cluster design stands against that bound, and the plan per fusion site.

Both kernels are thread-block-cluster launches for ``sm_90a``: a cluster of
``K`` CTAs owns a tile of ``n`` samples, each CTA a contiguous share of
every sample's rows, loaded into shared memory by bulk asynchronous copies.
:func:`_plan` picks ``K``, ``n`` and what stays resident; it runs here in
Python so the CPU tests can pin it, and the C entry points check the shared
memory it sizes.

Layouts follow the JAX kernel's features and torch's weights: ``f0``, ``f1``
are contiguous (B, S, C) maps (a ``channels_last`` NCHW map permuted to
NHWC and flattened is such a view), ``wsq`` (D, 2C) and ``w_i`` (C, D) are
``nn.Linear`` weights in their own (out, in) layout, read in place.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..utils import tracing
from .build import load

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Hopper's limits for one CTA and one portable cluster, and the kernels'
# constants (csrc/mmtm_cluster.cuh).
CLUSTER = 8  # CTAs a cluster (the portable maximum)
MAX_TILE = 8  # samples a tile (accumulators a thread)
BARRIER_BYTES = 128
THREADS = 512  # a CTA, one CTA an SM
SMEM_PER_CTA = 232_448  # the most dynamic shared memory a CTA may opt into
# The weight-gradient kernel: 16 x 64 output tiles; enough batch chunks to
# put about WG_BLOCKS_PER_SM blocks on each SM, at least 8 rows a chunk.
WG_TILE = (16, 64)
WG_BLOCKS_PER_SM = 4
WG_MAX_CHUNKS = 16


class Plan(NamedTuple):
    """How one call is cut.  ``nmaps`` (B, S, C) maps stay in shared memory
    (forward: f0, f1; backward: do0, do1; 0 when they stream from global
    memory).  ``grid`` persistent clusters walk the ``tiles`` of ``n``
    samples."""

    K: int
    n: int
    nmaps: int
    rows_max: int  # a CTA's share of a sample's S rows, at most
    smem: int  # dynamic shared memory per CTA, bytes
    tiles: int
    grid: int  # clusters launched
    chunks: int = 1  # backward: batch chunks of the weight-gradient kernel
    rows_per_chunk: int = 0

    @property
    def mode(self):
        return "resident" if self.nmaps else "stream"


def _cdiv(a, b):
    return -(-a // b)


def _split(total, parts, r):
    """(lo, size): part r of ``total`` items cut into ``parts`` nearly
    equal runs (``split`` in csrc/mmtm_cluster.cuh)."""
    q, rem = divmod(total, parts)
    return r * q + min(r, rem), q + (r < rem)


def _smem_bytes(n, nmaps, rows_max, C, D, itemsize, direction):
    """A CTA's dynamic shared memory (``Layout`` in csrc/mmtm_cluster.cuh):
    the barrier, the resident maps, the f32 rows (forward: partial
    sums / gates, sq, e; backward: partial sums / dsq, dz (first the joint
    squeeze), g, de (first pre)) and the reduction scratch."""
    vec = 16 // itemsize
    row_floats = n * ((4 if direction == "fwd" else 6) * C + _cdiv(D, 4) * 4)
    tmp = 4 * THREADS * (vec if direction == "fwd" else max(n, vec))
    return BARRIER_BYTES + nmaps * n * rows_max * C * itemsize + 4 * row_floats + tmp


def _plan(B, S, C, D, itemsize, direction, clusters, sms) -> Optional[Plan]:
    """The launch plan for one call, ``direction`` "fwd" or "bwd", on a card
    with ``sms`` SMs that holds ``clusters`` clusters at once.

    The two resident maps (forward f0, f1; backward do0, do1) stay in shared
    memory, read once from global memory; where one sample's do not fit a
    cluster, they stream (read again for the scale).  A tile costs a fixed
    chain of cluster syncs and weight reads whatever its size, so the tile
    size is the smallest that gives the fewest waves of tiles over the
    card's clusters.  None when even the f32 rows do not fit (C or D too
    large)."""
    K = CLUSTER
    rows_max = _cdiv(S, K)
    clusters = max(clusters, 1)
    for nmaps in (2, 0):
        fits = [n for n in range(1, min(B, MAX_TILE) + 1)
                if _smem_bytes(n, nmaps, rows_max, C, D, itemsize, direction) <= SMEM_PER_CTA]
        if fits:
            break
    else:
        return None
    waves = lambda n: _cdiv(_cdiv(B, n), clusters)
    n = min(fits, key=lambda n: (waves(n), n))
    tiles = _cdiv(B, n)
    plan = Plan(K, n, nmaps, rows_max, _smem_bytes(n, nmaps, rows_max, C, D, itemsize, direction), tiles,
                min(tiles, clusters))
    return plan if direction == "fwd" else plan._replace(**_wg_chunks(B, C, D, sms))


def _wg_chunks(B, C, D, sms):
    """Batch chunks of the weight-gradient kernel: enough blocks to fill the
    card's ``sms`` SMs, at least 8 rows a chunk, and no empty chunk."""
    tn, tk = WG_TILE
    blocks = sum(_cdiv(n, tn) * _cdiv(k, tk) for n, k in ((D, 2 * C), (C, D), (C, D)))
    want = min(_cdiv(WG_BLOCKS_PER_SM * sms, blocks), WG_MAX_CHUNKS, _cdiv(B, 8))
    rows = _cdiv(B, want)
    return {"chunks": _cdiv(B, rows), "rows_per_chunk": rows}


def _tile_rows(plan, B):
    """The samples of each cluster tile, as the kernels take them."""
    return [range(t * plan.n, min(B, t * plan.n + plan.n)) for t in range(plan.tiles)]


def _bulk_copies(plan, B, S, C, itemsize):
    """Every bulk copy the kernels issue: (CTA rank, tile, map, sample,
    shared-memory byte offset, global byte offset, bytes)."""
    copies = []
    for t, samples in enumerate(_tile_rows(plan, B)):
        for r in range(plan.K):
            s0, ns = _split(S, plan.K, r)
            for m in range(plan.nmaps):
                for j, b in enumerate(samples):
                    if ns:
                        dst = BARRIER_BYTES + (m * plan.n + j) * plan.rows_max * C * itemsize
                        copies.append((r, t, m, b, dst, (b * S + s0) * C * itemsize, ns * C * itemsize))
    return copies


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
    """Shapes, devices, dtypes and contiguity of the gating inputs; the
    biases b0, b1 may be None (the backward does not read them).  Returns
    (B, S, C, D)."""
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
    expected = {k: v for k, v in expected.items() if v[0] is not None}
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
    plan = _check_kernel_shapes("mmtm_gating", f0, f1, B, S, C, D, "fwd")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (f0, f1, wsq, bsq, w0, b0, w1, b1)):
        raise RuntimeError(
            "mmtm_gating's CUDA kernel returns tensors without a grad_fn; to train through it call "
            "MMTMGatingFunction.apply, or call mmtm_gating under torch.no_grad()"
        )

    out0 = torch.empty_like(f0)
    out1 = torch.empty_like(f1)
    rows = lambda n: torch.empty((B, n), dtype=torch.float32, device=f0.device)
    sq0, sq1, g0, g1 = rows(C), rows(C), rows(C), rows(C)

    lib = _library("mmtm_gating", "mmtm_gating_forward", 14, 10)
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream(f0.device).cuda_stream
        args = (*(t.data_ptr() for t in (f0, f1, wsq, bsq, w0, b0, w1, b1, out0, out1, sq0, sq1, g0, g1)),
                B, S, C, D, _DTYPE_CODES[f0.dtype], plan.K, plan.n, plan.nmaps, plan.smem, plan.grid, stream)
        # the span's markers bracket the launch alone, so they time the kernel
        with tracing.span("gating.forward", device=f0.device):
            err = lib.mmtm_gating_forward(*args)
    if err != 0:
        raise RuntimeError(f"mmtm_gating_forward launch failed: CUDA error {err}")
    mmtm_gating.launches += 1
    return out0, out1, sq0, sq1, g0, g1


mmtm_gating.launches = 0


def _check_kernel_shapes(what, f0, f1, B, S, C, D, direction) -> Plan:
    """What the CUDA kernels take beyond :func:`_check`; returns the plan."""
    if f0.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {f0.device}")
    if C % 8:
        raise ValueError(f"the CUDA kernel needs C % 8 == 0 (16-byte vectors), got C={C}")
    plan = kernel_plan(direction, B, S, C, D, f0.dtype)
    if plan is None:
        raise ValueError(f"the CUDA kernel supports 2C and D only while a tile's f32 rows fit shared memory, "
                         f"got C={C}, D={D}")
    for name, t in (("f0", f0), ("f1", f1)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads")
    return plan


def _library(name, fn_name, n_pointers, n_ints):
    """``csrc/<name>.cu`` loaded, its entry point typed: the pointers, the
    ints, then the stream."""
    lib = load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    return lib


_CARD = {}


def _card(direction, dtype):
    """(clusters of the kernel the current card holds at once with the most
    shared memory a plan takes, the card's SMs), asked once per kernel,
    dtype and card."""
    device = torch.cuda.current_device()
    key = (direction, dtype, device)
    if key not in _CARD:
        most = Plan(CLUSTER, 1, 0, 0, SMEM_PER_CTA, 1, 1)
        _CARD[key] = (max(1, max_active_clusters(direction, dtype, most)),
                      torch.cuda.get_device_properties(device).multi_processor_count)
    return _CARD[key]


def kernel_plan(direction, B, S, C, D, dtype) -> Optional[Plan]:
    """The plan a CUDA call of that shape takes on the current card."""
    return _plan(B, S, C, D, torch.tensor([], dtype=dtype).element_size(), direction, *_card(direction, dtype))


def max_active_clusters(direction, dtype, plan) -> int:
    """How many of the kernel's clusters fit on the current card at once for
    ``plan`` (``cudaOccupancyMaxActiveClusters``); ``direction`` "fwd" for
    the forward, "bwd" for the backward's map kernel."""
    name, fn_name = {"fwd": ("mmtm_gating", "mmtm_gating_forward_clusters"),
                     "bwd": ("mmtm_gating_bwd", "mmtm_gating_backward_clusters")}[direction]
    fn = getattr(load(name), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    count = ctypes.c_int(0)
    err = fn(_DTYPE_CODES[dtype], plan.K, plan.smem, ctypes.addressof(count))
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    return count.value


def cuda_launches(direction) -> int:
    """CUDA kernels the ``direction`` ("fwd" or "bwd") library has launched
    so far, counted in its C code at each launch the runtime accepts (the
    difference across a wrapper call is that call's launches)."""
    fn = load({"fwd": "mmtm_gating", "bwd": "mmtm_gating_bwd"}[direction]).mmtm_cuda_launches
    fn.restype = ctypes.c_ulonglong
    fn.argtypes = []
    return int(fn())


def mmtm_gating_bwd_plain(do0, do1, f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1,
                          dg0c=None, dg1c=None, dsq0c=None, dsq1c=None):
    """Plain PyTorch version of the fused backward, the arithmetic of
    ``_bwd_pallas`` / ``_bwd_jax`` (``mmtm_pallas.py:309-385``) in torch's
    weight layout: ``do_i`` rounded to the features' dtype, everything else
    in f32, ``pre`` recomputed from the unrounded f32 squeeze.  ``None``
    cotangents on sq or g are zero.  Returns (df0, df1) in the features'
    dtype and the f32 gradients (dwsq (D, 2C), dbsq, dw0 (C, D), db0, dw1,
    db1)."""
    S, C = f0.shape[1], f0.shape[2]
    add = lambda x, c: x if c is None else x + c.float()
    do0, do1 = do0.to(f0.dtype).float(), do1.to(f1.dtype).float()
    dz0 = add((do0 * f0.float()).sum(dim=1), dg0c) * g0 * (1.0 - g0)
    dz1 = add((do1 * f1.float()).sum(dim=1), dg1c) * g1 * (1.0 - g1)
    joint = torch.cat([sq0, sq1], dim=1)
    wsqf = wsq.float()
    pre = joint @ wsqf.t() + bsq.float()
    e = torch.relu(pre)
    de = (dz0 @ w0.float() + dz1 @ w1.float()) * (pre > 0.0)
    djoint = de @ wsqf
    dsq0, dsq1 = add(djoint[:, :C], dsq0c), add(djoint[:, C:], dsq1c)
    df0 = (do0 * g0[:, None, :] + dsq0[:, None, :] / S).to(f0.dtype)
    df1 = (do1 * g1[:, None, :] + dsq1[:, None, :] / S).to(f1.dtype)
    return df0, df1, de.t() @ joint, de.sum(dim=0), dz0.t() @ e, dz0.sum(dim=0), dz1.t() @ e, dz1.sum(dim=0)


def mmtm_gating_bwd(do0, do1, f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1,
                    dg0c=None, dg1c=None, dsq0c=None, dsq1c=None):
    """Fused MMTM gating backward (see :func:`mmtm_gating_bwd_plain` for
    the arithmetic and the results).  ``do_i`` are (B, S, C) in the
    features' dtype; ``g_i``, ``sq_i`` and the optional row cotangents are
    (B, C) float32; the weights are the forward's.

    On CPU tensors it runs :func:`mmtm_gating_bwd_plain`; on CUDA tensors
    it launches the kernel (building it at first use) or raises.  Each
    kernel launch adds one to ``mmtm_gating_bwd.launches``."""
    B, S, C, D = _check(f0, f1, wsq, bsq, w0, None, w1, None)
    rows = {"g0": g0, "g1": g1, "sq0": sq0, "sq1": sq1, "dg0c": dg0c, "dg1c": dg1c, "dsq0c": dsq0c, "dsq1c": dsq1c}
    for name, t in {"do0": do0, "do1": do1}.items():
        if t.shape != f0.shape or t.dtype != f0.dtype or t.device != f0.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(f0.shape)} {f0.dtype} tensor on {f0.device}")
    for name, t in rows.items():
        if t is not None and (t.shape != (B, C) or t.dtype != torch.float32 or t.device != f0.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B}, {C}) float32 tensor on {f0.device}")
    if f0.device.type == "cpu":
        return mmtm_gating_bwd_plain(do0, do1, f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1, dg0c, dg1c, dsq0c, dsq1c)
    plan = _check_kernel_shapes("mmtm_gating_bwd", f0, f1, B, S, C, D, "bwd")
    for name, t in (("do0", do0), ("do1", do1)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads")

    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=f0.device)
    df0, df1 = torch.empty_like(f0), torch.empty_like(f1)
    grads = [f32(D, 2 * C), f32(D), f32(C, D), f32(C), f32(C, D), f32(C)]
    scratch = [f32(B, 2 * C), f32(B, D), f32(B, D)]  # dz = [dz0 | dz1], e = relu(pre), de
    if plan.chunks > 1:  # the chunks' partial weight gradients and the output tiles' counters
        tn, tk = WG_TILE
        tiles = -(-max(C, D) // tn) * -(-max(2 * C, D) // tk)
        scratch += [f32(plan.chunks, 2 * C * D + D + 2 * (C * D + C)),
                    torch.empty(3 * tiles, dtype=torch.int32, device=f0.device)]
    else:
        scratch += [None, None]
    ptr = lambda t: None if t is None else t.data_ptr()

    lib = _library("mmtm_gating_bwd", "mmtm_gating_backward", 29, 11)
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream(f0.device).cuda_stream
        args = (*(ptr(t) for t in (do0, do1, f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1, dg0c, dg1c, dsq0c, dsq1c,
                                   df0, df1, *grads, *scratch)),
                B, S, C, D, _DTYPE_CODES[f0.dtype], plan.K, plan.n, plan.nmaps, plan.smem, plan.grid,
                plan.chunks, stream)
        with tracing.span("gating.backward", device=f0.device):
            err = lib.mmtm_gating_backward(*args)
    if err != 0:
        raise RuntimeError(f"mmtm_gating_backward launch failed: CUDA error {err}")
    mmtm_gating_bwd.launches += 1
    return (df0, df1, *grads)


mmtm_gating_bwd.launches = 0


class MMTMGatingFunction(torch.autograd.Function):
    """The fused gating forward and backward under autograd, as
    ``fused_mmtm_gating``'s ``custom_vjp`` binds them (``mmtm_pallas.py:
    281-388``): the forward saves the features, the weights and the f32
    squeeze and gate rows; the backward takes cotangents on all six outputs
    (``None`` for an unused one) and returns the weights' gradients in the
    weights' dtypes.  On CUDA tensors both directions launch kernels."""

    @staticmethod
    def forward(ctx, f0, f1, wsq, bsq, w0, b0, w1, b1):
        outs = mmtm_gating(f0, f1, wsq, bsq, w0, b0, w1, b1)
        ctx.save_for_backward(f0, f1, wsq, bsq, w0, w1, *outs[2:])
        ctx.bias_dtypes = (b0.dtype, b1.dtype)
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, do0, do1, dsq0, dsq1, dg0, dg1):
        f0, f1, wsq, bsq, w0, w1, sq0, sq1, g0, g1 = ctx.saved_tensors
        do0 = torch.zeros_like(f0) if do0 is None else do0.to(f0.dtype).contiguous()
        do1 = torch.zeros_like(f1) if do1 is None else do1.to(f1.dtype).contiguous()
        row = lambda t: None if t is None else t.float().contiguous()
        df0, df1, dwsq, dbsq, dw0, db0, dw1, db1 = mmtm_gating_bwd(
            do0, do1, f0, f1, g0, g1, sq0, sq1, wsq, bsq, w0, w1, row(dg0), row(dg1), row(dsq0), row(dsq1)
        )
        b0_dtype, b1_dtype = ctx.bias_dtypes
        return (df0, df1, dwsq.to(wsq.dtype), dbsq.to(bsq.dtype), dw0.to(w0.dtype), db0.to(b0_dtype),
                dw1.to(w1.dtype), db1.to(b1_dtype))
