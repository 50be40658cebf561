"""Device milliseconds a train step spends between the markers of the
program's ``step.update`` span (the BDR sums, SGD, the controller's update,
the step outputs), over its ``train.step`` count.  The interval between two
markers holds whatever idle lies inside it."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["step.update"], "train.step", "device_ms")
