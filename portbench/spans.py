"""Host spans the benchmark puts around the calls it makes into the
program: bound methods of its own objects and the iterator it hands the
loop.  Each span is timed by the host clock and, under the profiler, also
recorded as a ``record_function`` range of the same name, so the trace can
say what the host was doing while the device waited.  The program is not
edited."""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self):
        self.seconds = defaultdict(list)

    def timed(self, name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.seconds[name].append(time.perf_counter() - t0)

        return wrapper

    def wrap_method(self, obj, attr, name):
        """Time ``obj.attr`` (a bound method) on this instance only."""
        setattr(obj, attr, self.timed(name, getattr(obj, attr)))


class TimedIterable:
    """``iterable`` with each ``next`` timed as the span ``name``; its other
    attributes (``set_epoch``) pass through."""

    def __init__(self, iterable, spans, name):
        self._iterable = iterable
        self._spans = spans
        self._name = name

    def __getattr__(self, attr):
        return getattr(self._iterable, attr)

    def __iter__(self):
        it = iter(self._iterable)
        step = self._spans.timed(self._name, lambda: next(it))
        while True:
            try:
                yield step()
            except StopIteration:
                return
