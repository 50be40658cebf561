"""Host milliseconds a train step spends taking its batch from the data
pipeline: the program's ``train.data`` spans (each ``next`` of the epoch
loop) over its ``train.step`` count; the program's counterpart of
``data_wait_ms.train``."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["train.data"], "train.step", "host_ms")
