"""Device milliseconds a served request spends between the markers of the
program's ``gating.forward`` spans, which bracket each launch of the fused
gating forward kernel, over its ``predict`` count.  The interval between
two markers holds whatever idle lies inside it."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["gating.forward"], "predict", "device_ms")
