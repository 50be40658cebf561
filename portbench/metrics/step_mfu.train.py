"""The whole train step's share of the card's float32 peak: the
configuration's model FLOPs a trained sample (forward, data and weight
gradients) times the real samples of one epoch, over that epoch's time on
the host clock with the profiler off (the traced window's first epoch),
over 67 TFLOP/s."""

from portbench import flops, peaks


def read(run):
    if not run.samples or not run.untraced_s:
        return None
    return 100.0 * flops.train_flops(run.arch, run.spatial) * run.samples / run.untraced_s / peaks.F32_FLOPS
