"""Device milliseconds a train step spends in PyTorch's generic elementwise
and reduction kernels; most of it is the masked train BatchNorm, which is
plain tensor operations."""

from portbench import kernels


def read(run):
    if not run.units:
        return None
    seconds = run.trace.seconds(kernels.ELEMENTWISE)
    return 1e3 * seconds / run.units if seconds else None
