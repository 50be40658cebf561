"""The trace reduction and every per-layer reader on a small canned trace."""

import pytest

from portbench import bench, flops, peaks, trace

MS = 1_000_000  # ns


def canned():
    """A 100 ms window: a convolution 0-30 ms, an elementwise kernel 30-50,
    a gating forward 50-51 and its backward 51-53, a host-to-device copy
    60-70, a BatchNorm kernel from 95 on; the device idles 53-60 (the host
    in the benchmark's data span, an operation inside it ending at 56) and
    70-95 (the host in ``aten::item`` inside a ``portbench.request``)."""
    device = [
        (0, 30 * MS, "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw"),
        (30 * MS, 50 * MS, "void at::native::vectorized_elementwise_kernel<4, ...>"),
        (50 * MS, 51 * MS, "void gating_fwd_kernel<float>(...)"),
        (51 * MS, 52 * MS, "void gating_bwd_map_kernel<float>(...)"),
        (52 * MS, 53 * MS, "void weight_grad_kernel(...)"),
        (60 * MS, 70 * MS, "Memcpy HtoD (Pageable -> Device)"),
        (95 * MS, 120 * MS, "cudnn::bn_fw_tr_1C11_kernel_NCHW"),  # clipped to the window
    ]
    host = [
        (0, 100 * MS, trace.WINDOW),
        (53 * MS, 60 * MS, "portbench.data"),
        (54 * MS, 56 * MS, "aten::index_select"),
        (70 * MS, 95 * MS, "aten::item"),
        (65 * MS, 99 * MS, "portbench.request"),
    ]
    return trace.reduce(device, host)


def test_reduce():
    tr = canned()
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.030 + 0.020 + 0.003 + 0.010 + 0.005)
    assert tr.idle == pytest.approx({"portbench.data": 0.007, "aten::item": 0.025})
    assert tr.seconds(r"cudnn::bn") == pytest.approx(0.005)
    b = tr.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(0.030) and len(b["idle_gaps"]) == 2


def test_window_is_required():
    with pytest.raises(ValueError):
        trace.reduce([], [])


def record(name, units, samples, spans=None):
    return bench.RunRecord(bench.find_cell(name), canned(), spans=spans or {}, units=units, samples=samples,
                           untraced_s=0.08)


def read(cell_name, metric, rec):
    return bench.find_cell(cell_name).reader(metric).read(rec)


def test_train_readers():
    name = "mvcnn.train.guided_b128"
    rec = record(name, 2, 256, {"portbench.data": [0.001, 0.003], "portbench.flips": [0.0002, 0.0002],
                                "portbench.train_batch": [0.05, 0.06]})
    assert read(name, "data_wait_ms.train", rec) == pytest.approx(2.0)
    assert read(name, "host_ms_per_step.train", rec) == pytest.approx(55.2)
    assert read(name, "conv_ms.train", rec) == pytest.approx(15.0)  # the BatchNorm kernel is not a convolution
    assert read(name, "elementwise_ms.train", rec) == pytest.approx(10.0)
    assert read(name, "device_idle_share.train", rec) == pytest.approx(32.0)  # 68 busy ms of the 100 traced
    mfu = 100 * flops.train_flops(rec.arch, rec.spatial) * 256 / 0.08 / peaks.F32_FLOPS
    assert read(name, "step_mfu.train", rec) == pytest.approx(mfu)
    least = sum(flops.least_seconds(*flops.gating_fwd_counts(128, S, C))
                + flops.least_seconds(*flops.gating_bwd_counts(128, S, C))
                for S, C in flops.gating_sites(rec.arch, rec.spatial))
    assert read(name, "gating_roofline.train", rec) == pytest.approx(100 * least * 2 / 0.003)


def test_serve_readers():
    name = "mvcnn.serve.b128"
    rec = record(name, 4, 512)
    assert read(name, "h2d_ms.serve", rec) == pytest.approx(2.5)
    assert read(name, "device_idle_share.serve", rec) == pytest.approx(32.0)
    least = sum(flops.least_seconds(*flops.gating_fwd_counts(128, S, C)) for S, C in flops.gating_sites(rec.arch, rec.spatial))
    assert read(name, "gating_roofline.serve", rec) == pytest.approx(100 * least * 4 / 0.001)
    mfu = 100 * flops.forward_flops(rec.arch, rec.spatial) * 512 / 0.08 / peaks.F32_FLOPS
    assert read(name, "step_mfu.serve", rec) == pytest.approx(mfu)


def test_readers_that_find_nothing_return_none():
    empty = trace.reduce([], [(0, 10 * MS, trace.WINDOW)])
    for name in ("mvcnn.train.guided_b128", "mvcnn.serve.b128"):
        cell = bench.find_cell(name)
        rec = bench.RunRecord(cell, empty, spans={}, units=3, samples=0)
        for m in cell.per_layer:
            assert cell.reader(m["name"]).read(rec) is None, m["name"]
