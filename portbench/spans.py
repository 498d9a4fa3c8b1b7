"""The program's own spans, read after a traced run.

The port keeps a span log (``minivectordb_tpu_torch/utils/telemetry.py``:
name, start and end on ``time.time_ns`` — the clock of the profiler's
events — span and parent ids, request id, thread, and for some spans the
device milliseconds between two CUDA events). It records only while a
profiler runs, so a ``--trace 1`` run holds the spans of its window. Here
the log is clipped to the traced window, and the device's idle stretches
are named by the innermost program span that covered each one.

A program that keeps no span log, or a run without a trace, gives None.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import sys

PORT_TELEMETRY = "minivectordb_tpu_torch.utils.telemetry"
OUTSIDE = "outside the program"


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int | None
    request_id: int
    thread_id: int
    device_ms: float | None = None


def port_log():
    """The span log of the port loaded in this process, or None where it
    is not loaded or keeps no span log."""
    read = getattr(sys.modules.get(PORT_TELEMETRY), "spans", None)
    return read() if callable(read) else None


def program_spans(run, log=None):
    """The program's spans (``log``, the port's log by default) that
    overlap the run's traced window, each clipped to it, or None without a
    trace or without spans."""
    p = run.profile
    if p is None:
        return None
    log = port_log() if log is None else log
    out = [Span(r.name, max(r.start_ns, p.start_ns), min(r.end_ns, p.end_ns), r.span_id,
                r.parent_id, r.request_id, r.thread_id, r.device_ms)
           for r in log or () if r.end_ns > p.start_ns and r.start_ns < p.end_ns]
    return out or None


def idle_gaps(profile) -> list:
    """The (start_ns, end_ns) stretches of the traced window in which no
    operation ran on the device."""
    edges = [profile.start_ns]
    for a, b in profile.busy_intervals():
        edges += [a, b]
    edges.append(profile.end_ns)
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def idle_by_span(run, log=None):
    """Idle seconds of the device in the traced window by the innermost
    program span covering each idle stretch's middle (``OUTSIDE`` where
    none does), or None without a trace or without spans."""
    spans = program_spans(run, log)
    if spans is None:
        return None
    # a span that starts with its parent sorts after it: the longer first,
    # and the later opened (the larger id) of two alike
    spans.sort(key=lambda s: (s.start_ns, -s.end_ns, s.span_id))
    starts = [s.start_ns for s in spans]
    # the latest end among the spans that start up to each one: the walk
    # back from a middle stops where no earlier span can still cover it
    reach = list(itertools.accumulate((s.end_ns for s in spans), max))
    out: dict = {}
    for a, b in idle_gaps(run.profile):
        mid = (a + b) // 2
        label = OUTSIDE
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and reach[i] >= mid:
            # of the spans covering the middle, the one that started last
            # is the innermost
            if spans[i].end_ns >= mid:
                label = spans[i].name
                break
            i -= 1
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return out


def mean_ms(run, name: str, per_request: bool = False):
    """Mean host milliseconds of the spans ``name`` in the traced window
    (with ``per_request``, their total over the requests that have one),
    or None where there is none."""
    took = [(s.request_id, s.end_ns - s.start_ns) for s in program_spans(run) or ()
            if s.name == name]
    if not took:
        return None
    n = len({r for r, _ in took}) if per_request else len(took)
    return 1e-6 * sum(d for _, d in took) / n


def mean_device_ms(run, name: str):
    """Mean device milliseconds of the spans ``name`` that timed the device
    (their CUDA events) in the traced window, or None where there is none."""
    ms = [s.device_ms for s in program_spans(run) or ()
          if s.name == name and s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
