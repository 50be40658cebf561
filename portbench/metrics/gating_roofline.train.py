"""The fused gating kernels' share of their roofline in a train step: the
least time of the forward and backward calls at every MMTM site (bytes or
FLOPs over the published peaks, whichever is longer) over their device
time."""

from portbench import flops, kernels


def read(run):
    spent = run.trace.seconds(kernels.GATING_FORWARD) + run.trace.seconds(kernels.GATING_BACKWARD)
    if not spent:
        return None
    least = 0.0
    for S, C in flops.gating_sites(run.arch, run.spatial):
        least += flops.least_seconds(*flops.gating_fwd_counts(run.batch, S, C))
        least += flops.least_seconds(*flops.gating_bwd_counts(run.batch, S, C))
    return 100.0 * least * run.units / spent
