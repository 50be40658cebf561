"""Share of the traced requests' time in which no operation ran on the
device: 1 - their busy seconds (the union of the device's operations'
intervals) over their window, both from the one traced pass.  The profiler
loads the host, so where the host paces the device this reads higher than
untraced requests would."""


def read(run):
    if not run.trace.window_s or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
