"""Three times the forward's model operations of the real tokens (queries
and passages) trained on in the traced window, as a percent of the peak
over the window."""

from portbench import counts, readers


def read(run):
    p = run.profile
    if p is None or not run.facts.get("steps"):
        return None
    flops = 3.0 * readers.forward_flops(run, [list(q) + list(s) for q, s in run.facts["steps"]])
    return counts.mfu_share(flops, p.window_s, run.facts["dtype"])
