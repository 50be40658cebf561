"""Device milliseconds a served request spends in host-to-device copies,
from the profiler's copy events."""

from portbench import kernels


def read(run):
    if not run.units:
        return None
    seconds = run.trace.seconds(kernels.HOST_TO_DEVICE)
    return 1e3 * seconds / run.units if seconds else None
