"""What the metric readers share: a run's device trace reduced to
per-call times and roofline shares. Each reader in ``metrics/`` returns
None where its run has nothing for it to read (no trace, no launch of its
kernel), never 0."""

from __future__ import annotations

from portbench import counts, families


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


def family(run):
    """The configuration's model and its family module."""
    model = run.cell.config["model"]
    return model, families.of(model)


def attention_least(run, kernel: str, lengths_of_calls, launches: str = "full") -> float:
    """Least seconds of one attention kernel (``kernel`` a kind of
    ``counts.attention_work``) for each call (a list of its sequences' real
    lengths), launched by the layers the family's ``attention`` lists under
    ``launches``, over the pairs it gives them."""
    model, fam = family(run)
    att = fam.attention(model)[launches]
    dtype = run.facts["dtype"]
    return sum(att["layers"] * counts.least_seconds(*counts.attention_work(
        kernel, list(lengths), att["heads"], att["head_dim"], dtype,
        pairs=sum(att["pairs"](n) for n in lengths)), dtype)
        for lengths in lengths_of_calls)


def forward_flops(run, lengths_of_calls) -> float:
    """The family's model operations of each call's forward, summed."""
    model, fam = family(run)
    return sum(fam.forward_flops(model, list(lengths)) for lengths in lengths_of_calls)
