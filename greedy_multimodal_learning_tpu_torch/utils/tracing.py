"""The port's own spans: named ranges at the layer boundaries of the
training and serving paths, kept in memory while tracing is on.

Tracing is on while ``torch.profiler`` runs (``torch.autograd._profiler_enabled``)
or while an operator's :func:`enable` holds.  Off, :func:`span` returns one
shared object that does nothing: no allocation, no ``record_function``, no
CUDA event, no lock.  On, each span records its name, its parent span (the
innermost open span of its thread), the unit it belongs to (the train step
or the ``predict`` call current when it began), its thread, and its start
and end, and enters ``torch.profiler.record_function(name)``, so the range
sits in the profiler's trace beside the operations it launched.  A span
given a CUDA ``device`` also records a CUDA event (``enable_timing``, from a
pool) on the device's current stream at entry and at exit; the device
milliseconds between the two are worked out only when read, and hold
whatever idle lies between the markers.

Stamps are ``time.perf_counter_ns()`` moved onto the Unix epoch by an offset
taken once, the clock on which the profiler stamps its events, so an idle
gap in a trace can be put down to the span the host was in.

The profiler's switch is per thread, and ``threading`` threads do not
inherit it (the autograd engine's threads do).  While the thread that saw
the profiler start has not yet seen it stop, spans on other threads where
the profiler is off (a pipeline's producer) are recorded too, without a
``record_function`` range in the trace.  When tracing turns on after being
off the record is cleared, so it holds one traced stretch::

    with torch.profiler.profile():
        trainer.train_loop(pipeline, epochs=1)
    tracing.summary()  # {"train.step": {"count", "host_ms", "self_ms", "device_ms"}, ...}

    tracing.enable()  # without the profiler
    trainer.predict(pipeline)
    tracing.disable()
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch

# perf_counter_ns() + _EPOCH_OFFSET_NS is Unix-epoch ns
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

_records = []  # closed spans, in the order they closed
_pool = []  # CUDA events to reuse
_local = threading.local()  # .stack: the thread's open spans
_enabled = False  # enable() holds
_owner = None  # ident of the thread that saw the profiler start, until it sees it stop
_unit = None  # the unit of the spans that give none


def _now_ns():
    return time.perf_counter_ns() + _EPOCH_OFFSET_NS


class Record:
    """One closed span.  ``parent`` is the enclosing span's record (same
    thread) or None; ``markers`` the (start, end) CUDA events or None."""

    __slots__ = ("name", "parent", "unit", "thread", "start_ns", "end_ns", "markers", "_device_ms")

    def __init__(self, name, parent=None, unit=None, thread=None, start_ns=0, end_ns=0, markers=None):
        self.name, self.parent, self.unit, self.thread = name, parent, unit, thread
        self.start_ns, self.end_ns, self.markers = start_ns, end_ns, markers
        self._device_ms = None

    @property
    def host_ms(self):
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self):
        """Device milliseconds between the span's markers (waits for the
        end marker), or None without markers."""
        if self._device_ms is None and self.markers is not None:
            start, end = self.markers
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
        return self._device_ms


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def drop(self):
        pass


_OFF = _Off()


def _event():
    try:
        return _pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("record", "stream", "range", "dropped")

    def __init__(self, name, device, unit):
        global _unit
        if unit is not None:
            _unit = unit
        self.record = Record(name, unit=_unit, thread=threading.get_ident())
        self.stream = torch.cuda.current_stream(device) if getattr(device, "type", None) == "cuda" else None
        self.range = torch.profiler.record_function(name)
        self.dropped = False

    def __enter__(self):
        rec = self.record
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        rec.parent = stack[-1] if stack else None
        stack.append(rec)
        rec.start_ns = _now_ns()
        self.range.__enter__()
        if self.stream is not None:
            rec.markers = (_event(), _event())
            rec.markers[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        rec = self.record
        if rec.markers is not None:
            rec.markers[1].record(self.stream)
        self.range.__exit__(*exc)
        rec.end_ns = _now_ns()
        _local.stack.pop()
        if self.dropped:
            if rec.markers is not None:
                _pool.extend(rec.markers)
        else:
            _records.append(rec)
        return False

    def drop(self):
        """Leave this span out of the record."""
        self.dropped = True


def on():
    """Whether a span opened on this thread now is recorded."""
    global _owner
    if _enabled:
        return True
    if torch.autograd._profiler_enabled():
        if _owner is None:  # turned on after being off
            _owner = threading.get_ident()
            clear()
        return True
    if _owner is None:
        return False
    if _owner == threading.get_ident():  # the profiler has stopped
        _owner = None
        return False
    return True  # a thread the running profiler does not reach


def span(name, device=False, unit=None):
    """A context manager timing its block as the span ``name``.  ``device``:
    the ``torch.device`` the block's work runs on (markers on a CUDA
    device).  ``unit``: the train step or ``predict`` call this span and
    every later one belong to."""
    if not on():
        return _OFF
    return _Span(name, device, unit)


def iterate(name, iterable, units=None):
    """``iterable`` with each ``next`` timed as the span ``name``; ``units``,
    an iterator, gives each item's unit.  The ``next`` that ends the
    iteration is not recorded."""
    it = iter(iterable)
    while True:
        with span(name, unit=None if units is None else next(units)) as s:
            try:
                item = next(it)
            except StopIteration:
                s.drop()
                return
        yield item


def enable():
    """Record spans until :func:`disable`, profiler or not; clears the record
    when tracing was off."""
    global _enabled
    if not on():
        clear()
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def records():
    """The closed spans since the last clear, in the order they closed."""
    return list(_records)


def clear():
    """Empties the record; its markers go back to the pool."""
    global _unit
    done = list(_records)
    _records.clear()
    _unit = None
    for rec in done:
        if rec.markers is not None:
            _pool.extend(rec.markers)
            rec.markers = None


def summary(recs=None):
    """Per span name: ``count``, ``host_ms`` (total), ``self_ms`` (each span's
    duration less what its child spans cover, summed) and ``device_ms``
    (total between markers; None where no span of the name had markers),
    over ``recs`` (the record by default)."""
    recs = records() if recs is None else list(recs)
    children = defaultdict(list)
    for rec in recs:
        if rec.parent is not None:
            children[id(rec.parent)].append((rec.start_ns, rec.end_ns))
    out = {}
    for rec in recs:
        s = out.setdefault(rec.name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += rec.host_ms
        s["self_ms"] += (rec.end_ns - rec.start_ns - _covered(rec, children.get(id(rec), ()))) / 1e6
        device = rec.device_ms()
        if device is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + device
    return out


def _covered(rec, intervals):
    """ns of ``rec``'s interval that the ``intervals`` cover."""
    total, reach = 0, rec.start_ns
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, rec.end_ns)
        if end > start:
            total += end - start
            reach = end
    return total
