"""The fused gating forward kernel's share of its roofline in a served
request: its least time at every MMTM site (bytes or FLOPs over the
published peaks, whichever is longer) over its device time."""

from portbench import flops, kernels


def read(run):
    spent = run.trace.seconds(kernels.GATING_FORWARD)
    if not spent:
        return None
    least = sum(flops.least_seconds(*flops.gating_fwd_counts(run.batch, S, C))
                for S, C in flops.gating_sites(run.arch, run.spatial))
    return 100.0 * least * run.units / spent
