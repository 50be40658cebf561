"""The whole serving path's share of the card's float32 peak: the
configuration's forward FLOPs a sample times the samples of the traced
window's requests, over the time the same number of requests took just
before on the host clock with the profiler off, over 67 TFLOP/s."""

from portbench import flops, peaks


def read(run):
    if not run.samples or not run.untraced_s:
        return None
    return 100.0 * flops.forward_flops(run.arch, run.spatial) * run.samples / run.untraced_s / peaks.F32_FLOPS
