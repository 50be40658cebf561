"""Host milliseconds a served request spends blocked on device-to-host
copies: the program's ``host.wait`` spans (the logits of each modality) over
its ``predict`` count."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["host.wait"], "predict", "host_ms")
