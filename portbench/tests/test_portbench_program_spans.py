"""The readers of the program's own spans (``program_spans.py``) on a canned
summary, on a program without spans, and, on the card, the gating spans of
a traced 2-D train run:

    python -m pytest portbench/tests/test_portbench_program_spans.py -m card
"""

import sys
import time

import pytest

from portbench import bench, program_spans

TRAIN, SERVE = "mvcnn.train.guided_b128", "mvcnn.serve.b128"
SITES = 3  # the 2-D family's MMTM sites, one gating call each


def span(count, host_ms, device_ms=None):
    return {"count": count, "host_ms": host_ms, "self_ms": host_ms, "device_ms": device_ms}


def canned():
    """Two train steps and two requests, as the program's summary gives them."""
    return {
        "train.data": span(2, 1.0), "train.flips": span(2, 0.4), "train.step": span(2, 100.0),
        "train.callbacks": span(4, 3.0), "host.wait": span(3, 30.0), "train.fetch": span(1, 31.0),
        "step.forward": span(2, 40.0, 90.0), "step.backward": span(2, 50.0, 150.0),
        "step.update": span(2, 10.0, 40.0), "gating.forward": span(2 * SITES + 2 * SITES, 2.0, 1.2),
        "gating.backward": span(2 * SITES, 3.0, 1.8),
        "predict": span(2, 120.0), "predict.data": span(2, 50.0), "predict.h2d": span(2, 12.0),
        "predict.forward": span(2, 30.0, 70.0), "predict.fetch": span(2, 20.0), "predict.post": span(2, 2.0),
        "pipeline.collate": span(2, 48.0),
    }


EXPECTED = {
    (TRAIN, "pipeline_next_ms.train"): 0.5,
    (TRAIN, "step_host_ms.train"): 50.2,
    (TRAIN, "callbacks_ms.train"): 1.5,
    (TRAIN, "host_wait_ms.train"): 15.0,
    (TRAIN, "forward_device_ms.train"): 45.0,
    (TRAIN, "backward_device_ms.train"): 75.0,
    (TRAIN, "update_device_ms.train"): 20.0,
    (TRAIN, "gating_device_ms.train"): 1.5,
    (SERVE, "collate_wait_ms.serve"): 25.0,
    (SERVE, "h2d_host_ms.serve"): 6.0,
    (SERVE, "forward_device_ms.serve"): 35.0,
    (SERVE, "host_wait_ms.serve"): 15.0,
    (SERVE, "gating_device_ms.serve"): 0.6,
}
DEVICE = [k for k in EXPECTED if "device" in k[1]]


def read(cell_name, metric):
    cell = bench.find_cell(cell_name)
    return cell.reader(metric).read(bench.RunRecord(cell, trace=None, units=2, samples=256))


@pytest.mark.parametrize("cell_name,metric", list(EXPECTED))
def test_reader_on_a_canned_summary(cell_name, metric, monkeypatch):
    monkeypatch.setattr(program_spans, "summary", canned)
    assert read(cell_name, metric) == pytest.approx(EXPECTED[cell_name, metric])


@pytest.mark.parametrize("cell_name,metric", DEVICE)
def test_device_reader_without_markers_reads_none(cell_name, metric, monkeypatch):
    without = {name: dict(s, device_ms=None) for name, s in canned().items()}
    monkeypatch.setattr(program_spans, "summary", lambda: without)
    assert read(cell_name, metric) is None


@pytest.mark.parametrize("cell_name,metric", list(EXPECTED))
def test_reader_without_the_unit_span_reads_none(cell_name, metric, monkeypatch):
    unit = "train.step" if cell_name == TRAIN else "predict"
    monkeypatch.setattr(program_spans, "summary", lambda: {n: s for n, s in canned().items() if n != unit})
    assert read(cell_name, metric) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent of the spans' change has no tracing module: the summary is
    empty and every new reader finds nothing."""
    monkeypatch.setitem(sys.modules, "greedy_multimodal_learning_tpu_torch.utils.tracing", None)
    assert program_spans.summary() == {}
    for cell_name, metric in EXPECTED:
        assert read(cell_name, metric) is None, metric


def test_the_program_names_no_benchmark():
    from pathlib import Path

    program = Path(bench.ROOT).parent / "greedy_multimodal_learning_tpu_torch"
    for path in program.rglob("*.py"):
        assert "portbench" not in path.read_text(), path


@pytest.mark.card
def test_gating_spans_on_the_2d_train_cell():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = bench.find_cell(TRAIN)
    result = bench.run_cell(cell, seed=2147483999, seconds=40, trace=1, device="cuda", t_start=time.time())
    spans = program_spans.summary()
    steps = spans["train.step"]["count"]
    assert steps == -(-cell.config["train_samples"] // cell.traffic["batch"])
    for name in ("gating.forward", "gating.backward"):
        assert spans[name]["count"] == SITES * steps, name
        assert spans[name]["device_ms"] > 0, name
    assert result["metrics"]["gating_device_ms.train"]["value"] > 0
