"""Model operations of the real tokens embedded in the traced window, as a
percent of the peak over the window."""

from portbench import counts, readers


def read(run):
    p = run.profile
    if p is None or not run.facts.get("calls"):
        return None
    return counts.mfu_share(readers.forward_flops(run, run.facts["calls"]), p.window_s,
                            run.facts["dtype"])
