"""The small-batch scan (ops/scan.py) against its roofline: the device time
of one call's kernels against reading the corpus once for its query."""

from portbench import counts, readers


def read(run):
    calls = readers.calls_in_trace(run, "call")
    if run.profile is None or not calls:
        return None
    f = run.facts
    least = calls * counts.least_seconds(
        *counts.scan_work(f["rows"], f["dim"], f["batch"], f["k"]))
    return readers.roofline(run, None, least)
