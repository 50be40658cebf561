"""Masked train-mode BatchNorm, forward and backward: the CUDA kernels
(``csrc/masked_batch_norm.cu``), their plain PyTorch versions, the wrappers
that pick between them by device, and the ``torch.autograd.Function`` that
binds the two.

The train-mode branch of ``models/layers.py::_MaskedBatchNorm`` on CUDA
tensors: batch statistics over the rows whose (B,) ``mask`` is non-zero (all
rows without one) and every spatial position, in float32 whatever the map's
dtype; two levels of sums (the mean, then the centred squares against it);
the biased variance normalizes, the running variance takes ``var * n /
max(n - 1, 1)``.  The backward is derived from that graph (the source's
header has the formulas) and saves only x, the mask and the per-channel
statistics.  The JAX package has no kernel here (its ``TorchBatchNorm`` is
plain jnp ops that XLA fuses), so none is replaced.

Maps are (B, C, *spatial) in channels-last memory (the models' layout: C
innermost, moved 16 bytes a thread) or contiguous.  ``relu`` takes the ReLU
that follows a BatchNorm into both passes.  Under data parallelism
(``world``) the kernels run in phases with the sums all-reduced over the
data group between them, as ``SyncBatchNorm`` does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..parallel import mesh as parallel
from .build import load

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256  # a block (kThreads in the source)
WARPS = THREADS // 32
FORWARD_PHASES = ((0, 1), (2, 3), (4, 4))  # the launches under data parallelism
BACKWARD_PHASES = ((0, 1), (2, 2))


def stats_at(C):
    """Offsets into the saved statistics (``StatsAt`` in the source): s1
    (C, the masked sums), n (the count), s2 (C, the masked centred squares),
    R (C, the masked centred sums), mean (C), rstd (C); 5C + 1 floats."""
    return {"s1": 0, "n": C, "s2": C + 1, "r": 2 * C + 1, "mean": 3 * C + 1, "rstd": 4 * C + 1, "size": 5 * C + 1}


def split_stats(stats, C):
    at = stats_at(C)
    return {k: stats[v:v + (1 if k == "n" else C)] for k, v in at.items() if k != "size"}


def _per_channel(x):
    return (1, -1) + (1,) * (x.dim() - 2)


def _row_weights(mask, x):
    """The (B,) float32 row weights, broadcast over a map like x."""
    m = torch.ones(x.shape[0], device=x.device) if mask is None else mask.float()
    return m, m.view((-1,) + (1,) * (x.dim() - 1))


def masked_batch_norm_plain(x, weight, bias, mask=None, eps=1e-5, relu=False, world=None):
    """The kernels' forward in plain PyTorch: (y in x's dtype, the saved
    statistics, see :func:`stats_at`).  Under data parallelism (``world``,
    a :class:`~..parallel.mesh.World`) the sums and the count are summed over
    its data group, (s1, n) and then (s2, R)."""
    xf = x.float()
    dims = (0,) + tuple(range(2, x.dim()))
    shape = _per_channel(x)
    m, mb = _row_weights(mask, x)
    C = x.shape[1]
    first = torch.cat([(xf * mb).sum(dim=dims), (m.sum() * math.prod(x.shape[2:]))[None]])
    if world is not None:
        parallel.all_reduce_(first, world.data_group)
    s1, n = first[:C], first[C]
    mean = s1 / n
    d = xf - mean.view(shape)
    second = torch.cat([(d.square() * mb).sum(dim=dims), (d * mb).sum(dim=dims)])
    if world is not None:
        parallel.all_reduce_(second, world.data_group)
    s2 = second[:C]
    rstd = torch.rsqrt(s2 / n + eps)
    y = d * (rstd * weight).view(shape) + bias.view(shape)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), torch.cat([first, second, mean, rstd])


@torch.no_grad()
def update_running_plain(running_mean, running_var, stats, momentum):
    """The running statistics' update from the saved statistics, in place:
    the mean and the unbiased variance ``var * n / max(n - 1, 1)``."""
    s = split_stats(stats, running_mean.numel())
    n = s["n"][0]
    var = s["s2"] / n
    unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    running_mean.mul_(1.0 - momentum).add_(momentum * s["mean"])
    running_var.mul_(1.0 - momentum).add_(momentum * unbiased)


def masked_batch_norm_backward_plain(dy, x, weight, bias, mask, stats, relu=False, world=None):
    """The kernels' backward in plain PyTorch: (dx in x's dtype, dweight,
    dbias).  dweight and dbias are this rank's; under ``world`` the two
    per-channel sums are summed over its data group before dx."""
    C = x.shape[1]
    s = split_stats(stats, C)
    dims = (0,) + tuple(range(2, x.dim()))
    shape = _per_channel(x)
    _, mb = _row_weights(mask, x)
    d = x.float() - s["mean"].view(shape)
    inv = s["rstd"] * weight
    g = dy.float()
    if relu:
        g = torch.where(d * inv.view(shape) + bias.view(shape) > 0, g, torch.zeros((), device=g.device))
    sums = torch.cat([g.sum(dim=dims), (g * d).sum(dim=dims)])
    dbias, dweight = sums[:C].clone(), sums[C:] * s["rstd"]
    if world is not None:
        parallel.all_reduce_(sums, world.data_group)
    A, Bs = sums[:C], sums[C:]
    n = s["n"][0]
    k = -(Bs * weight * s["rstd"] ** 3) / n
    c0 = (inv * A + k * s["r"]) / n
    dx = g * inv.view(shape) + mb * (k.view(shape) * d - c0.view(shape))
    return dx.to(x.dtype), dweight, dbias


def kernel_layout(x) -> bool:
    """True for a channels-last map (C innermost), False for a contiguous
    one; raises for any other layout, which the kernels do not take."""
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
    if fmt is not None and x.is_contiguous(memory_format=fmt):
        return True
    if x.is_contiguous():
        return False
    raise ValueError(f"the masked BatchNorm kernel takes channels-last or contiguous maps, got strides {x.stride()}")


def _vec(channels_last, C, dtype, *tensors):
    """Channels a thread moves at once: 16 bytes where C and every map's
    address allow, else 1 (always 1 for contiguous NCHW)."""
    v = 16 // torch.tensor([], dtype=dtype).element_size()
    if channels_last and C % v == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return v
    return 1


def plan_grid(channels_last, B, C, L, vec, max_blocks) -> int:
    """Blocks a launch takes: as many as the card holds (``max_blocks``),
    fewer where the map gives a block less than a row a thread lane
    (channels-last) or a plane a warp (NCHW)."""
    if channels_last:
        tpr = C // vec
        lanes = THREADS // min(tpr, THREADS)
        want = -(-B * L // lanes)
    else:
        want = -(-B * C // WARPS)
    return max(1, min(max_blocks, want))


_MAX_BLOCKS = {}


def max_blocks(backward, dtype, vec, channels_last) -> int:
    """The largest cooperative grid of the kernel on the current card,
    asked once per kernel and card."""
    key = (backward, dtype, vec, channels_last, torch.cuda.current_device())
    if key not in _MAX_BLOCKS:
        fn = load("masked_batch_norm").mbn_max_blocks
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        count = ctypes.c_int(0)
        err = fn(int(backward), _DTYPE_CODES[dtype], vec, int(channels_last), ctypes.addressof(count))
        if err != 0 or count.value < 1:
            raise RuntimeError(f"mbn_max_blocks failed: CUDA error {err}, {count.value} blocks")
        _MAX_BLOCKS[key] = count.value
    return _MAX_BLOCKS[key]


def cuda_launches() -> int:
    """CUDA kernels the library has launched so far, counted in its C code at
    each launch the runtime accepts."""
    fn = load("masked_batch_norm").mbn_cuda_launches
    fn.restype = ctypes.c_ulonglong
    fn.argtypes = []
    return int(fn())


def _entry(name):
    lib = load("masked_batch_norm")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = I
        fn.argtypes = ([P] * 9 + [ctypes.c_longlong] + [I] * 5 + [F] * 3 + [I] * 5 + [P] if name == "mbn_forward"
                       else [P] * 11 + [ctypes.c_longlong] + [I] * 9 + [P])
    return fn


def _check(x, weight, bias, mask):
    """Shapes, devices and dtypes of the inputs; returns the mask as (B,)
    float32 contiguous, or None."""
    if x.dim() < 3:
        raise ValueError(f"the masked BatchNorm takes (B, C, *spatial) maps, got {tuple(x.shape)}")
    B, C = x.shape[:2]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the masked BatchNorm supports float32 and bfloat16 maps, got {x.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None or t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be a ({C},) float32 tensor on {x.device}")
    if mask is not None:
        if mask.shape != (B,) or mask.device != x.device:
            raise ValueError(f"mask must be a ({B},) tensor on {x.device}, got {tuple(mask.shape)} on {mask.device}")
        mask = mask.float().contiguous()
    return mask


def _ptr(t):
    return None if t is None else t.data_ptr()


def masked_batch_norm(x, weight, bias, running_mean, running_var, mask=None, momentum=0.1, eps=1e-5, update=True,
                      relu=False, world=None):
    """Masked train-mode BatchNorm forward.  Returns (y in x's dtype and
    layout, the saved statistics (5C + 1 float32, :func:`stats_at`)); with
    ``update`` the running statistics take the batch's, in place.

    On CPU tensors it runs :func:`masked_batch_norm_plain`; on CUDA tensors
    it launches the kernel (building it at first use) or raises.  Each CUDA
    call adds one to ``masked_batch_norm.launches``."""
    mask = _check(x, weight, bias, mask)
    if x.device.type == "cpu":
        y, stats = masked_batch_norm_plain(x, weight, bias, mask, eps, relu, world)
        if update:
            update_running_plain(running_mean, running_var, stats, momentum)
        return y, stats
    channels_last = kernel_layout(x)
    weight, bias = weight.contiguous(), bias.contiguous()
    B, C = x.shape[:2]
    L = math.prod(x.shape[2:])
    y = torch.empty_like(x)
    vec = _vec(channels_last, C, x.dtype, x, y)
    grid = plan_grid(channels_last, B, C, L, vec, max_blocks(False, x.dtype, vec, channels_last))
    f32 = lambda n: torch.empty(n, dtype=torch.float32, device=x.device)
    part = f32((grid if channels_last else B) * 2 * C)
    stats = f32(stats_at(C)["size"])
    if update:
        for name, t in (("running_mean", running_mean), ("running_var", running_var)):
            if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous ({C},) float32 tensor on {x.device}")
    fn = _entry("mbn_forward")
    reduced = {1: (0, C + 1), 3: (C + 1, 3 * C + 1)}  # after phases 1 and 3: (s1, n), then (s2, R)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for lo, hi in ((0, 4),) if world is None else FORWARD_PHASES:
            err = fn(*(_ptr(t) for t in (x, y, mask, weight, bias)),
                     *((_ptr(running_mean), _ptr(running_var)) if update else (None, None)),
                     part.data_ptr(), stats.data_ptr(), L, B, C, _DTYPE_CODES[x.dtype], vec, int(channels_last),
                     eps, momentum, 1.0 - momentum, int(update), int(relu), lo, hi, grid, stream)
            if err != 0:
                raise RuntimeError(f"mbn_forward launch failed: CUDA error {err}")
            if world is not None and hi in reduced:
                a, b = reduced[hi]
                parallel.all_reduce_(stats[a:b], world.data_group)
    masked_batch_norm.launches += 1
    return y, stats


masked_batch_norm.launches = 0


def masked_batch_norm_backward(dy, x, weight, bias, mask, stats, relu=False, world=None):
    """Masked train-mode BatchNorm backward from the forward's saved
    statistics.  Returns (dx in x's dtype and layout, dweight, dbias), the
    last two this rank's.

    On CPU tensors it runs :func:`masked_batch_norm_backward_plain`; on CUDA
    tensors it launches the kernel or raises.  Each CUDA call adds one to
    ``masked_batch_norm_backward.launches``."""
    mask = _check(x, weight, bias, mask)
    dy = dy.to(x.dtype)
    if x.device.type == "cpu":
        return masked_batch_norm_backward_plain(dy, x, weight, bias, mask, stats, relu, world)
    channels_last = kernel_layout(x)
    if dy.stride() != x.stride():  # the gradient in the input's layout
        dy = torch.empty_like(x).copy_(dy)
    weight, bias = weight.contiguous(), bias.contiguous()
    B, C = x.shape[:2]
    L = math.prod(x.shape[2:])
    dx = torch.empty_like(x)
    vec = _vec(channels_last, C, x.dtype, x, dy, dx)
    grid = plan_grid(channels_last, B, C, L, vec, max_blocks(True, x.dtype, vec, channels_last))
    f32 = lambda n: torch.empty(n, dtype=torch.float32, device=x.device)
    part, red, dweight, dbias = f32((grid if channels_last else B) * 2 * C), f32(2 * C), f32(C), f32(C)
    fn = _entry("mbn_backward")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for lo, hi in ((0, 2),) if world is None else BACKWARD_PHASES:
            err = fn(*(_ptr(t) for t in (dy, x, dx, mask, weight, bias, part, stats, red, dweight, dbias)),
                     L, B, C, _DTYPE_CODES[x.dtype], vec, int(channels_last), int(relu), lo, hi, grid, stream)
            if err != 0:
                raise RuntimeError(f"mbn_backward launch failed: CUDA error {err}")
            if world is not None and hi == 1:
                parallel.all_reduce_(red, world.data_group)
    masked_batch_norm_backward.launches += 1
    return dx, dweight, dbias


masked_batch_norm_backward.launches = 0


class MaskedBatchNormFunction(torch.autograd.Function):
    """The masked train-mode BatchNorm under autograd: the forward saves x,
    the weight, the bias, the mask and the per-channel statistics; the
    backward returns the gradients of x, the weight and the bias.  On CUDA
    tensors both directions launch kernels; on CPU tensors both run the
    plain versions."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, mask, momentum, eps, update, relu, world):
        y, stats = masked_batch_norm(x, weight, bias, running_mean, running_var, mask, momentum, eps, update, relu,
                                     world)
        ctx.save_for_backward(x, weight, bias, mask, stats)
        ctx.relu, ctx.world = relu, world
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mask, stats = ctx.saved_tensors
        dx, dweight, dbias = masked_batch_norm_backward(dy, x, weight, bias, mask, stats, ctx.relu, ctx.world)
        return dx, dweight, dbias, None, None, None, None, None, None, None, None
