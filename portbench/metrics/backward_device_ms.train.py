"""Device milliseconds a train step spends between the markers of the
program's ``step.backward`` span (zeroing the gradients, the backward, the
data-parallel reductions), over its ``train.step`` count.  The interval
between two markers holds whatever idle lies inside it."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["step.backward"], "train.step", "device_ms")
