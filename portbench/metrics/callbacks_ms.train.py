"""Host milliseconds a train step spends in the callback hooks around it
(``on_batch_begin``, ``on_forward_begin``, ``on_backward_end``,
``on_batch_end``) and its batch logs: the program's ``train.callbacks``
spans over its ``train.step`` count."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["train.callbacks"], "train.step", "host_ms")
