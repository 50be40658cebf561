"""Host milliseconds a served request waits for its batch: the program's
``predict.data`` spans (each ``next`` of ``Trainer.predict``'s loop, which
waits for the pipeline's collating thread) over its ``predict`` count."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["predict.data"], "predict", "host_ms")
