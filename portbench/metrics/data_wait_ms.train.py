"""Host milliseconds a train step spends in the data pipeline's ``next``,
from the benchmark's span around the iterator it hands the loop."""


def read(run):
    seconds = run.spans.get("portbench.data")
    if not seconds or not run.units:
        return None
    return 1e3 * sum(seconds) / run.units
