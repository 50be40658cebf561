"""The traced window: ``torch.profiler`` over CPU and CUDA activity, reduced
to what the per-layer readers take.

* ``window_s``: the window's own ``record_function`` range, which ends after
  a synchronize, so every device operation it caused lies inside it;
* ``busy_s``: the union of the intervals in which any device operation
  (kernel, copy, fill) ran, inside the window;
* ``device_s``: device seconds by operation name (summed durations; one
  stream, so they do not overlap);
* ``idle``: the gaps between the busy intervals, summed by what the host
  was doing at each gap's middle: the innermost host range that covers it
  (an operation, a runtime call or one of the benchmark's ``portbench.*``
  spans), else ``host: none recorded``.  The :data:`NAMED_GAPS` longest
  gaps are named so; the rest, each no longer than the shortest of those,
  are summed as ``short gaps``.

The raw events are read from the profiler's results without building its
tree of Python objects, which is slow for a million events.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW = "portbench.window"
NAMED_GAPS = 500


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: dict = field(default_factory=dict)  # name -> seconds
    idle: dict = field(default_factory=dict)  # what the host did -> seconds of device idle

    def seconds(self, pattern):
        """Device seconds of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.device_s.items() if rx.search(name))

    def breakdown(self):
        """The 10 device operations that took most time, and the 10 host
        activities that left the device idle longest."""
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _times(event):
    if hasattr(event, "start_ns"):
        start = event.start_ns()
        end = event.end_ns() if hasattr(event, "end_ns") else start + event.duration_ns()
        return start, end
    start = event.start_us() * 1000
    return start, start + event.duration_us() * 1000


def _events(prof):
    results = prof.profiler.kineto_results
    device, host = [], []
    for e in results.events():
        start, end = _times(e)
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and (e.name().startswith("portbench.") or getattr(e, "is_user_annotation", lambda: False)()):
            continue  # a host range's shadow on the device timeline, not an operation
        (device if on_device else host).append((start, end, e.name()))
    return device, host


def run_traced(fn):
    """(fn's result, :class:`Trace` of the call).  Needs a CUDA device."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            result = fn()
            torch.cuda.synchronize()
    device, host = _events(prof)
    return result, reduce(device, host)


def reduce(device, host):
    """:class:`Trace` of raw events: ``device`` and ``host`` lists of
    (start ns, end ns, name); ``host`` holds the ``portbench.window``
    range."""
    windows = [(s, e) for s, e, n in host if n == WINDOW]
    if not windows:
        raise ValueError("the trace holds no portbench.window range")
    w0, w1 = windows[0]
    by_name = defaultdict(float)
    intervals = []
    for s, e, n in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name[n] += (e - s) / 1e9
            intervals.append((s, e))
    intervals.sort()
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, device_s=dict(by_name), idle=_name_gaps(gaps, host))


def _name_gaps(gaps, host):
    if not gaps:
        return {}
    host = [(s, e, n) for s, e, n in host if n != WINDOW]
    starts = np.array([s for s, _, _ in host], np.int64)
    ends = np.array([e for _, e, _ in host], np.int64)
    idle = defaultdict(float)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    for g0, g1 in gaps[NAMED_GAPS:]:
        idle["short gaps"] += (g1 - g0) / 1e9
    for g0, g1 in gaps[:NAMED_GAPS]:
        mid = (g0 + g1) // 2
        cover = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = host[cover[np.argmax(starts[cover])]][2] if cover.size else "host: none recorded"
        idle[name] += (g1 - g0) / 1e9
    return dict(idle)
