"""Host milliseconds a train step spends in ``Trainer.train_flips`` and
``Trainer.train_batch``: the program's ``train.flips`` and ``train.step``
spans over its ``train.step`` count (launches, and waits when the launch
queue is full); the program's counterpart of ``host_ms_per_step.train``."""

from portbench import program_spans


def read(run):
    return program_spans.per_unit(["train.flips", "train.step"], "train.step", "host_ms")
