"""Device milliseconds a train step spends in cuDNN's convolution kernels
(forward, data and weight gradients), by kernel name.  A bare ``cudnn``
does not count: cuDNN's BatchNorm kernels carry it too."""

from portbench import kernels


def read(run):
    if not run.units:
        return None
    seconds = run.trace.seconds(kernels.CONVOLUTION)
    return 1e3 * seconds / run.units if seconds else None
