"""What the metric readers share: a run's device trace reduced to
per-call times and roofline shares. Each reader in ``metrics/`` returns
None where its run has nothing for it to read (no trace, no launch of its
kernel), never 0."""

from __future__ import annotations

from portbench import counts


def calls_in_trace(run, span: str) -> int:
    return sum(1 for s in run.spans if s[0] == span)


def idle_pct(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def kernel_seconds(run, pattern: str | None = None):
    """Device seconds of the kernels matching ``pattern`` in the trace, or
    None without a trace or a match."""
    if run.profile is None:
        return None
    ops = run.profile.kernels(pattern)
    return run.profile.seconds(ops) if ops else None


def roofline(run, pattern: str, least_s: float):
    """Percent of the roofline ``least_s`` (the least time of all the work
    the matching launches did) that their measured time reached."""
    took = kernel_seconds(run, pattern)
    if took is None or least_s <= 0:
        return None
    return counts.roofline_share(least_s, took)


def attention_least(run, kernel: str, lengths_of_calls) -> float:
    """Least seconds of one attention kernel launched once a layer for each
    call (a list of its sequences' real lengths)."""
    f = run.facts
    hd = f["hidden"] // f["heads"]
    return sum(f["layers"] * counts.least_seconds(*counts.attention_work(
        kernel, list(lengths), f["heads"], hd, f["dtype"]), f["dtype"])
        for lengths in lengths_of_calls)


def forward_flops(run, lengths_of_calls) -> float:
    f = run.facts
    return sum(counts.encoder_forward_flops(list(lengths), f["hidden"], f["intermediate"],
                                            f["layers"]) for lengths in lengths_of_calls)
