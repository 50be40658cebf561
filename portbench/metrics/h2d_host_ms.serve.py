"""Host milliseconds a served request spends handing its batch to the
device: the program's ``predict.h2d`` spans (the copies of the images and
the mask from host memory) over its ``predict`` count."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["predict.h2d"], "predict", "host_ms")
