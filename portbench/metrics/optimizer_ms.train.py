"""Device milliseconds per training step of the operations launched inside
the optimizer's step (the profiler's "Optimizer.step" range: AdamW)."""


def read(run):
    p, steps = run.profile, len(run.facts.get("steps", ()))
    if p is None or not steps or not p.ranges.get("Optimizer.step"):
        return None
    return 1e3 * p.ranges["Optimizer.step"] / steps
