"""Device milliseconds per search of every kernel of the fused scan other
than phase 1 (ops/fused_scan.py phases 2 and 3)."""

from portbench import readers

PHASE1 = r"phase1_\w*kernel"


def read(run):
    took = readers.kernel_seconds(run)
    if took is None or readers.kernel_seconds(run, PHASE1) is None:
        return None
    rest = took - readers.kernel_seconds(run, PHASE1)
    return 1e3 * rest / readers.calls_in_trace(run, "result")
