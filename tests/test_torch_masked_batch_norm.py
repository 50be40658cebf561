"""The masked train-mode BatchNorm's kernel algorithm (the plain versions in
``ops/masked_batch_norm.py``: two levels of sums forward, the hand-derived
backward) against autograd of the plain ops of ``models/layers.py`` on the
CPU, and the wrapper's dispatch, layouts, grid and launch counters."""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from greedy_multimodal_learning_tpu_torch import parallel
from greedy_multimodal_learning_tpu_torch.models import layers
from greedy_multimodal_learning_tpu_torch.models.layers import BatchNorm2d, BatchNorm3d, rematerialize
from greedy_multimodal_learning_tpu_torch.ops import masked_batch_norm as mbn
from greedy_multimodal_learning_tpu_torch.parallel.launch import run_ranks

B, C = 128, 8
MOMENTUM, EPS = 0.1, 1e-5
# (rtol, atol).  f32: the same arithmetic, the backward's sums in another
# grouping than autograd's.  bf16: x and dx are bf16 on both sides, so dx may
# round to a neighbouring bf16 value (2^-7 relative).
TOL = {torch.float32: {"y": (1e-6, 1e-6), "dx": (1e-4, 1e-5), "dp": (1e-4, 1e-4)},
       torch.bfloat16: {"y": (1e-6, 1e-6), "dx": (8e-3, 1e-3), "dp": (1e-4, 1e-4)}}


def _mask(kind):
    """(B,) float32 row weights: none, all ones, the padded tail of the 2-D
    cell's last step (115 of 128), a single valid row (the n - 1 clamp), and
    padding rows scattered through the batch."""
    if kind == "none":
        return None
    m = np.zeros(B, np.float32)
    if kind == "ones":
        m[:] = 1
    elif kind == "tail":
        m[:115] = 1
    elif kind == "single":
        m[17] = 1
    else:
        m[:] = 1
        m[[0, 5, 64, 127]] = 0
    return torch.from_numpy(m)


def _pair(dim, seed=0):
    """Two BatchNorms with the same drawn affine and running statistics."""
    rng = np.random.default_rng(seed)
    state = {"weight": rng.uniform(0.5, 1.5, C), "bias": rng.normal(size=C), "running_mean": rng.normal(size=C),
             "running_var": rng.uniform(0.5, 2.0, C)}
    state = {k: torch.from_numpy(v.astype(np.float32)) for k, v in state.items()}
    cls = BatchNorm2d if dim == 4 else BatchNorm3d
    out = []
    for _ in range(2):
        bn = cls(C)
        bn.load_state_dict(state, strict=False)
        out.append(bn)
    return out


def _map(dim, layout, dtype, seed=1):
    rng = np.random.default_rng(seed)
    spatial = (3, 5) if dim == 4 else (2, 3, 4)
    x = torch.from_numpy((3.0 * rng.normal(size=(B, C) + spatial) + 1.0).astype(np.float32)).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last if dim == 4 else torch.channels_last_3d)
    dy = torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(dtype)
    return x, dy


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), want.detach().float().numpy(), rtol=tol[0],
                               atol=tol[1], err_msg=what)


def _run_module(bn, x, dy, mask, relu):
    """y, dx, dweight, dbias of one train-mode call of ``bn``, leaving the
    module's running statistics updated."""
    x = x.detach().clone().requires_grad_(True)
    y = bn(x, train=True, mask=mask, relu=relu)
    y.backward(dy)
    return y, x.grad, bn.weight.grad, bn.bias.grad


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kind", ["none", "ones", "tail", "single", "scattered"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("dim", [4, 5])
def test_kernel_algorithm_matches_autograd_of_the_plain_ops(dim, layout, dtype, kind, relu, monkeypatch):
    """The route CUDA tensors take (the kernels' algorithm, here in its plain
    version) against autograd of the plain ops CPU tensors take: the output,
    dx, dweight and dbias, the running statistics, and the output's layout.
    dy is non-zero on the masked rows too."""
    x, dy = _map(dim, layout, dtype)
    mask = _mask(kind)
    plain_bn, kernel_bn = _pair(dim)
    want = _run_module(plain_bn, x, dy, mask, relu)
    monkeypatch.setattr(layers, "_kernel_route", lambda t: True)
    got = _run_module(kernel_bn, x, dy, mask, relu)
    tol = TOL[dtype]
    assert got[0].dtype == dtype and got[0].stride() == x.stride() and got[1].stride() == x.stride()
    for name, g, w, t in zip(("y", "dx", "dweight", "dbias"), got, want, (tol["y"], tol["dx"], tol["dp"], tol["dp"])):
        _close(g, w, t, name)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(kernel_bn, name), getattr(plain_bn, name), rtol=0, atol=0)


@pytest.mark.parametrize("dim", [4, 5])
def test_saved_statistics(dim):
    """The saved statistics hold the two levels of sums: s1 and n, then s2
    and R against the mean, the mean and rstd (biased variance)."""
    x, _ = _map(dim, "channels_last", torch.float32)
    mask = _mask("tail")
    _, stats = mbn.masked_batch_norm_plain(x, torch.ones(C), torch.zeros(C), mask, EPS)
    at = mbn.stats_at(C)
    assert stats.shape == (at["size"],)
    xd = x.double()
    m = mask.double().view((-1,) + (1,) * (dim - 1))
    dims = (0,) + tuple(range(2, dim))
    n = mask.double().sum() * np.prod(x.shape[2:])
    mean = (xd * m).sum(dims) / n
    d = xd - mean.view(1, -1, *([1] * (dim - 2)))
    want = {"s1": (xd * m).sum(dims), "s2": (d.square() * m).sum(dims), "r": (d * m).sum(dims), "mean": mean,
            "rstd": torch.rsqrt((d.square() * m).sum(dims) / n + EPS)}
    # R is a sum of ~1,700 centred values that cancel to 0: float32 leaves ~1e-4
    for name, value in want.items():
        np.testing.assert_allclose(stats[at[name]:at[name] + C].numpy(), value.numpy(), rtol=1e-5, atol=1e-3,
                                   err_msg=name)
    assert float(stats[at["n"]]) == float(n)


def test_recompute_leaves_the_running_statistics(monkeypatch):
    """Under ``rematerialize`` a block's BatchNorm runs twice (forward, then
    the backward's recompute) and updates the running statistics once, on
    the kernels' route as on the plain ops'; the gradients agree."""
    x, dy = _map(4, "channels_last", torch.float32)
    mask = _mask("tail")
    results = []
    for route in (False, True):
        monkeypatch.setattr(layers, "_kernel_route", lambda t, route=route: route)
        bn, once = _pair(4)
        xr = x.detach().clone().requires_grad_(True)
        rematerialize(lambda t: bn(t, True, mask, relu=True), xr).backward(dy)
        _run_module(once, x, dy, mask, True)
        for name in ("running_mean", "running_var"):
            torch.testing.assert_close(getattr(bn, name), getattr(once, name), rtol=0, atol=0)
        results.append((xr.grad, bn.weight.grad, bn.bias.grad))
    for name, got, want in zip(("dx", "dweight", "dbias"), results[1], results[0]):
        _close(got, want, (1e-4, 1e-5), name)


def _data_parallel_rank(rank):
    """One rank's half of the batch through a BatchNorm under data
    parallelism (a gloo group of two, the default data group), on the plain
    ops and on the kernels' route: y, dx, dweight, dbias and the running
    statistics of each."""
    dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(seconds=60))
    x, dy = _map(4, "channels_last", torch.float32)
    mask, rows = _mask("tail"), slice(64 * rank, 64 * rank + 64)
    out = []
    for route in (False, True):
        layers._kernel_route = lambda t, route=route: route
        bn, _ = _pair(4)
        xr = x[rows].clone().requires_grad_(True)
        with parallel.data_parallel(parallel.World(size=2, rank=rank, local_size=2)):
            bn(xr, True, mask[rows], relu=True).backward(dy[rows])
            y = bn(x[rows], True, mask[rows], relu=True).detach()  # the forward again: a second update
        out.append([y, xr.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var])
    dist.destroy_process_group()
    return out


def test_data_parallel_route_matches_the_plain_ops():
    """Under data parallelism the kernels' route sums (s1, n), then (s2, R)
    over the data group forward and (A, Bs) backward, as the plain ops'
    differentiable sums do: each rank's y, dx, dweight, dbias and running
    statistics agree with the plain ops'."""
    for rank, (plain, kernel) in enumerate(run_ranks(_data_parallel_rank, 2, timeout=120)):
        for name, got, want in zip(("y", "dx", "dweight", "dbias", "running_mean", "running_var"), kernel, plain):
            _close(got, want, (1e-4, 1e-5), f"rank {rank} {name}")


def test_update_false_leaves_the_running_statistics():
    x, _ = _map(4, "channels_last", torch.float32)
    bn, _ = _pair(4)
    before = (bn.running_mean.clone(), bn.running_var.clone())
    mbn.masked_batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, _mask("tail"), update=False)
    torch.testing.assert_close((bn.running_mean, bn.running_var), before, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; the forward returns y and the saved statistics."""
    x, dy = _map(4, "channels_last", torch.float32)
    bn, _ = _pair(4)
    launches = (mbn.masked_batch_norm.launches, mbn.masked_batch_norm_backward.launches)
    y, stats = mbn.masked_batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, _mask("tail"),
                                     update=False)
    want_y, want_stats = mbn.masked_batch_norm_plain(x, bn.weight, bn.bias, _mask("tail"), EPS)
    torch.testing.assert_close((y, stats), (want_y, want_stats), rtol=0, atol=0)
    got = mbn.masked_batch_norm_backward(dy, x, bn.weight, bn.bias, _mask("tail"), stats)
    want = mbn.masked_batch_norm_backward_plain(dy, x, bn.weight, bn.bias, _mask("tail"), stats)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (mbn.masked_batch_norm.launches, mbn.masked_batch_norm_backward.launches) == launches


def test_kernel_layouts():
    """Channels-last and contiguous maps are the kernels' two index maps;
    any other layout raises (a CUDA call would, before any launch)."""
    x = torch.zeros(2, 8, 3, 5)
    assert mbn.kernel_layout(x.contiguous(memory_format=torch.channels_last)) is True
    assert mbn.kernel_layout(x) is False
    assert mbn.kernel_layout(torch.zeros(2, 8, 2, 3, 5).contiguous(memory_format=torch.channels_last_3d)) is True
    with pytest.raises(ValueError, match="channels-last or contiguous"):
        mbn.kernel_layout(x.transpose(2, 3))


def test_wrapper_checks():
    x = torch.zeros(4, 8, 3, 3)
    with pytest.raises(ValueError, match=r"\(B, C, \*spatial\)"):
        mbn.masked_batch_norm(torch.zeros(4, 8), torch.ones(8), torch.zeros(8), torch.zeros(8), torch.ones(8))
    with pytest.raises(ValueError, match="weight"):
        mbn.masked_batch_norm(x, torch.ones(7), torch.zeros(8), torch.zeros(8), torch.ones(8))
    with pytest.raises(ValueError, match="mask"):
        mbn.masked_batch_norm(x, torch.ones(8), torch.zeros(8), torch.zeros(8), torch.ones(8), mask=torch.ones(3))
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        mbn.masked_batch_norm(x.half(), torch.ones(8), torch.zeros(8), torch.zeros(8), torch.ones(8))


def test_vector_width():
    """16 bytes a thread where C and the addresses allow, else 1; NCHW
    always 1."""
    x = torch.zeros(2, 24, 3, 3)
    assert mbn._vec(True, 24, torch.float32, x) == 4
    assert mbn._vec(True, 20, torch.bfloat16, x.bfloat16()) == 1  # 20 % 8
    assert mbn._vec(True, 64, torch.bfloat16, x.bfloat16()) == 8
    assert mbn._vec(False, 64, torch.float32, x) == 1
    assert mbn._vec(True, 24, torch.float32, x.view(-1)[1:]) == 1  # 4-byte offset


@pytest.mark.parametrize("case", [
    # (channels_last, B, C, L, vec, max_blocks, want)
    (True, 128, 64, 112 * 112, 4, 396, 396),  # 2-D stem: the whole card
    (True, 128, 512, 49, 4, 396, 396),  # 2-D layer4: 6272 rows, 2 a pass: still the whole card
    (True, 2, 512, 1, 4, 396, 1),  # two rows, two lanes: one block
    (True, 4, 2048, 1, 1, 396, 4),  # wider than a block: one lane a row
    (False, 8, 64, 16 * 56 * 56, 1, 396, 64),  # NCHW: a plane a warp
])
def test_grid(case):
    *args, want = case
    assert mbn.plan_grid(*args) == want


def test_stats_layout_agrees_with_the_source():
    """The offsets of the saved statistics are the source's StatsAt."""
    src = (mbn.load.__globals__["CSRC_DIR"] / "masked_batch_norm.cu").read_text()
    assert "return {0, C, C + 1, 2 * C + 1, 3 * C + 1, 4 * C + 1};" in src
    assert mbn.stats_at(8) == {"s1": 0, "n": 8, "s2": 9, "r": 17, "mean": 25, "rstd": 33, "size": 41}
    for name in ("mbn_forward_kernel", "mbn_backward_kernel"):
        assert name in src
