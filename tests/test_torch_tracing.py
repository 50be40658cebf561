"""The port's spans (``greedy_multimodal_learning_tpu_torch/utils/tracing.py``)
on the CPU, over a train epoch and ``predict`` calls on a small synthetic
ModelNet (two views of 32², batches of 4):

* off (no profiler, no ``enable``): nothing recorded, and neither
  ``record_function`` nor ``torch.cuda.Event`` called;
* under the CPU profiler: the train epoch's tree, one ``train.fetch`` with
  its ``host.wait``, the collation on the producer thread, and, in an epoch
  with no other thread, each span's stamps against the profiler's range of
  the same name;
* ``predict``'s five children, once a one-batch call;
* the record cleared when tracing turns on after being off;
* ``summary()``'s self time on hand-built records."""

import threading
from collections import defaultdict

import pytest
import torch

from greedy_multimodal_learning_tpu_torch.bootstrap import init_model
from greedy_multimodal_learning_tpu_torch.data import BatchPipeline, MultiviewModelNet
from greedy_multimodal_learning_tpu_torch.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch.engine import Trainer, make_optimizer
from greedy_multimodal_learning_tpu_torch.models import MMTMMVCNN
from greedy_multimodal_learning_tpu_torch.utils import tracing

NC = 4
N_TRAIN, BATCH = 8, 4
STEPS = N_TRAIN // BATCH
MS = 1_000_000  # ns
PREDICT_CHILDREN = ["predict.data", "predict.h2d", "predict.forward", "predict.fetch", "predict.post"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = make_synthetic_modelnet(str(tmp_path_factory.mktemp("tracing") / "d"), n_train=N_TRAIN, n_test=4,
                                   num_views=2, image_size=32, nclasses=NC)
    return MultiviewModelNet(root, "train", specific_view=[0, 1]), MultiviewModelNet(root, "test", specific_view=[0, 1])


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    assert not tracing.on()  # the profiler, if any, has stopped
    tracing.clear()


def _trainer():
    model = init_model(MMTMMVCNN(nclasses=NC), 0, "cpu")
    return Trainer(model, make_optimizer(model.parameters(), lr=0.01), device="cpu", verbose=False)


def _train_epoch(trainer, train, prefetch=2):
    loader = BatchPipeline(train, range(N_TRAIN), BATCH, shuffle=True, seed=1, prefetch=prefetch)
    trainer.train_loop(loader, epochs=1, steps_per_epoch=len(loader))


def _by_name(records):
    by = defaultdict(list)
    for rec in records:
        by[rec.name].append(rec)
    for recs in by.values():
        recs.sort(key=lambda r: r.start_ns)
    return by


def _profile_epoch(train, prefetch=2):
    """The records and the profiler's host ranges of one train epoch under
    the CPU profiler."""
    trainer = _trainer()
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train_epoch(trainer, train, prefetch)
    records = tracing.records()
    assert not tracing.on()
    ranges = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            ranges[e.name()].append((e.start_ns(), e.end_ns()))
    return records, ranges


@pytest.fixture(scope="module")
def profiled(data):
    return _profile_epoch(data[0])


@pytest.fixture(scope="module")
def profiled_alone(data):
    """As ``profiled``, with no thread beside the loop's: the pipeline
    collates in the loop's own thread, and the operators run on one thread.
    A thread that takes the interpreter lock between a span's stamp and the
    profiler's (a producer collating in Python) would put up to a switch
    interval, 5 ms, between them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _profile_epoch(data[0], prefetch=0)
    finally:
        torch.set_num_threads(threads)


def test_off_records_nothing_and_calls_no_profiler(data, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    trainer = _trainer()
    _train_epoch(trainer, data[0])
    out = trainer.predict(BatchPipeline(data[1], range(4), 4))
    assert len(out["indices"]) == 4
    assert tracing.records() == [] and tracing.summary() == {}
    assert tracing.span("a", device=torch.device("cpu")) is tracing.span("b")


def test_train_epoch_tree(profiled):
    records, _ = profiled
    by = _by_name(records)
    for name in ("train.data", "train.flips", "train.step"):
        assert len(by[name]) == STEPS, name
        assert [r.unit for r in by[name]] == list(range(STEPS)), name
        assert all(r.parent is None for r in by[name]), name
    # the hooks run on both sides of the step: before it, then after it with the batch logs
    assert len(by["train.callbacks"]) == 2 * STEPS
    assert [r.unit for r in by["train.callbacks"]] == [u for u in range(STEPS) for _ in range(2)]
    for step in by["train.step"]:
        kids = sorted((r for r in records if r.parent is step), key=lambda r: r.start_ns)
        assert [k.name for k in kids] == ["step.forward", "step.backward", "step.update"]
        assert step.start_ns <= kids[0].start_ns and kids[-1].end_ns <= step.end_ns
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert all(k.unit == step.unit for k in kids)
    (fetch,) = by["train.fetch"]
    waits = [r for r in by["host.wait"] if r.parent is fetch]
    assert len(waits) == len(by["host.wait"]) == 1
    assert fetch.start_ns > by["train.step"][-1].end_ns
    assert all(s["device_ms"] is None for s in tracing.summary(records).values())  # no markers on the CPU


def test_collation_is_recorded_on_the_producer_thread(profiled):
    records, _ = profiled
    collates = _by_name(records)["pipeline.collate"]
    main = _by_name(records)["train.step"][0].thread
    assert len(collates) == STEPS
    assert all(r.thread != main and r.parent is None for r in collates)


def test_stamps_agree_with_the_profiler_ranges(profiled_alone):
    records, ranges = profiled_alone
    by = _by_name(records)
    assert {"train.data", "pipeline.collate", "train.step", "step.forward", "host.wait"} <= set(by)
    for name in by:
        # the trace also holds the range of the ``next`` that ended the epoch's batches
        assert len(ranges[name]) == len(by[name]) + (name == "train.data"), name
        for rec in by[name]:
            gap = min(max(abs(rec.start_ns - s), abs(rec.end_ns - e)) for s, e in ranges[name])
            assert gap < MS, (name, gap)


def test_predict_records_its_children_once_a_batch(data):
    trainer = _trainer()
    tracing.enable()
    for rows in (range(0, 4), range(2, 4)):
        trainer.predict(BatchPipeline(data[1], rows, 4))
    tracing.disable()
    records = tracing.records()
    by = _by_name(records)
    calls = by["predict"]
    assert [c.unit for c in calls] == [1, 2] and all(c.parent is None for c in calls)
    for call in calls:
        kids = sorted((r for r in records if r.parent is call), key=lambda r: r.start_ns)
        assert [k.name for k in kids] == PREDICT_CHILDREN
        (fetch,) = [k for k in kids if k.name == "predict.fetch"]
        assert [r.name for r in records if r.parent is fetch] == ["host.wait"] * 2  # one a modality
    summary = tracing.summary(records)
    assert summary["predict"]["self_ms"] < summary["predict"]["host_ms"]
    assert summary["predict.forward"]["device_ms"] is None


def test_record_clears_when_tracing_turns_on():
    def names():
        return [r.name for r in tracing.records()]

    tracing.enable()
    with tracing.span("a"):
        pass
    tracing.disable()
    with tracing.span("off"):
        pass
    assert names() == ["a"]
    tracing.enable()
    with tracing.span("b"):
        pass
    tracing.enable()  # already on: kept
    tracing.disable()
    assert names() == ["b"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("c"):
            with tracing.span("d"):
                pass
        seen = []
        thread = threading.Thread(target=lambda: seen.append(tracing.on()))
        thread.start()
        thread.join(timeout=60)
        assert not thread.is_alive() and seen == [True]  # a thread the profiler does not reach
    assert names() == ["d", "c"] and not tracing.on()
    with tracing.span("off again"):
        pass
    assert names() == ["d", "c"]


def test_summary_self_time_is_duration_less_child_coverage():
    R = tracing.Record
    parent = R("p", start_ns=0, end_ns=10 * MS)
    a = R("a", parent=parent, start_ns=1 * MS, end_ns=3 * MS)
    b = R("b", parent=parent, start_ns=2 * MS, end_ns=5 * MS)  # overlaps a: 1-5 covered
    c = R("c", parent=parent, start_ns=9 * MS, end_ns=12 * MS)  # clipped to 9-10
    grandchild = R("g", parent=a, start_ns=1 * MS, end_ns=2 * MS)  # a's, not the parent's
    other = R("p", start_ns=20 * MS, end_ns=21 * MS)
    s = tracing.summary([parent, a, b, c, grandchild, other])
    assert s["p"] == {"count": 2, "host_ms": 11.0, "self_ms": 6.0, "device_ms": None}
    assert s["a"] == {"count": 1, "host_ms": 2.0, "self_ms": 1.0, "device_ms": None}
    assert s["c"]["self_ms"] == 3.0 and s["g"]["self_ms"] == 1.0
