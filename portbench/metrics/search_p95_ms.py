"""95th percentile, over every call completed in the window, of the time
from the call's start (the submit, for an async batch) to its result in the
caller's hands."""

from portbench.drivers.common import quantile


def read(run):
    return 1e3 * quantile(run.latencies_s, 95) if run.latencies_s else None
