"""Host milliseconds a train step spends blocked on device-to-host copies:
the program's ``host.wait`` spans (the epoch's fetch of the step outputs
and recordings) over its ``train.step`` count."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["host.wait"], "train.step", "host_ms")
