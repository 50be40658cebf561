"""Device milliseconds a train step spends between the markers of the
program's ``gating.forward`` and ``gating.backward`` spans, which bracket
each launch of the fused gating kernels, over its ``train.step`` count.
The interval between two markers holds whatever idle lies inside it."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["gating.forward", "gating.backward"], "train.step", "device_ms")
