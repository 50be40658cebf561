"""The program's own spans, read in the run's process: the summary of
``greedy_multimodal_learning_tpu_torch/utils/tracing.py`` (per span name:
``count``, ``host_ms``, ``self_ms``, ``device_ms``), which holds the traced
window's spans once the window has closed.  A program without that module
gives an empty summary, so every reader of it returns None."""

from __future__ import annotations


def summary():
    try:
        from greedy_multimodal_learning_tpu_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.summary()


def per_unit(names, unit, key):
    """``key`` (``host_ms`` or ``device_ms``) summed over the spans
    ``names``, over the count of the span ``unit`` (``train.step``: a train
    step; ``predict``: a request); None when the program recorded no
    ``unit`` span or no value of ``key`` under ``names``."""
    spans = summary()
    units = spans.get(unit, {}).get("count")
    values = [spans[n][key] for n in names if n in spans and spans[n][key] is not None]
    if not units or not values:
        return None
    return sum(values) / units
