"""Device milliseconds a train step spends between the markers of the
program's ``step.forward`` span (preprocessing, the model, the loss), over
its ``train.step`` count.  The interval between two markers holds whatever
idle lies inside it, so this is at least the device time of the forward's
operations."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["step.forward"], "train.step", "device_ms")
