"""Host milliseconds a train step spends in ``Trainer.train_flips`` and
``Trainer.train_batch`` (the flips, then the step's launches), from the
benchmark's spans around those methods of its own trainer."""


def read(run):
    seconds = run.spans.get("portbench.flips", []) + run.spans.get("portbench.train_batch", [])
    if not seconds or not run.units:
        return None
    return 1e3 * sum(seconds) / run.units
