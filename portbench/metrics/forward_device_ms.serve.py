"""Device milliseconds a served request spends between the markers of the
program's ``predict.forward`` span (preprocessing and the eval forward),
over its ``predict`` count.  The interval between two markers holds
whatever idle lies inside it, so this is at least the device time of the
forward's operations."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["predict.forward"], "predict", "device_ms")
