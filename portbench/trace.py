"""The device trace of a run's window: ``torch.profiler`` (CUPTI) around
the window, reduced to what the per-layer readers need.

Events are read from the profiler's kineto results directly (building its
per-event Python objects costs about 0.1 ms an event). Their times are unix
nanoseconds, the clock of the harness's spans (``time.time_ns``), so an idle
stretch of the device can be matched with what the host was doing then.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time

import torch


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    kind: str          # "kernel", "memcpy" or "memset"
    correlation: int


@dataclasses.dataclass
class Profile:
    ops: list                  # DeviceOp, in start order
    start_ns: int              # the traced window on the host clock
    end_ns: int
    ranges: dict               # CPU range name -> device seconds of the ops it launched
    spans: list                # the harness's (name, start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device
        (the union of the operations' intervals)."""
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def busy_intervals(self) -> list:
        out = []
        for op in self.ops:
            a = max(op.start_ns, self.start_ns)
            b = min(op.start_ns + op.dur_ns, self.end_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernels(self, pattern: str | None = None) -> list:
        """Kernel launches whose name matches the regular expression
        ``pattern`` (every kernel without one)."""
        rx = re.compile(pattern) if pattern else None
        return [op for op in self.ops
                if op.kind == "kernel" and (rx is None or rx.search(op.name))]

    def seconds(self, ops) -> float:
        return sum(op.dur_ns for op in ops) * 1e-9

    def idle_by_host(self) -> dict:
        """Idle seconds of the device in the window, by the harness span
        that covered each idle stretch's middle ("between calls" when
        none did)."""
        out: dict = {}
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        edges = [self.start_ns]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end_ns)
        for gap_start, gap_end in zip(edges[::2], edges[1::2]):
            if gap_end <= gap_start:
                continue
            mid = (gap_start + gap_end) // 2
            # the harness's spans follow one another on one thread: the last
            # one to start before the middle covers it, or none does
            i = bisect.bisect_right(starts, mid) - 1
            label = spans[i][0] if i >= 0 and spans[i][2] >= mid else "between calls"
            out[label] = out.get(label, 0.0) + (gap_end - gap_start) * 1e-9
        return out

    def breakdown(self) -> dict:
        """The ten device operations that took most time, summed by name,
        and the idle time by what the host was doing."""
        by_name: dict = {}
        for op in self.ops:
            key = op.name if len(op.name) <= 120 else op.name[:117] + "..."
            by_name[key] = by_name.get(key, 0.0) + op.dur_ns * 1e-9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_by_host().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


@contextlib.contextmanager
def profiled(run, cpu: bool = False, ranges: tuple = ()):
    """With ``run.trace``, trace what the body runs on the device and set
    ``run.profile``. The body opens the window (``common.start_window``
    sets ``run.window_start_ns``): the profiler starts before it, since its
    start takes seconds, and the traced window runs from the window's start
    to the body's end. ``cpu`` records host operations too, which
    ``ranges`` (names of CPU ranges, matched by their start, such as the
    optimizer's step) need."""
    if not run.trace:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        yield
        torch.cuda.synchronize()
        end = time.time_ns()
    run.profile = reduce(prof.profiler.kineto_results.events(), run.window_start_ns, end,
                         run.spans, ranges)


def reduce(events, start_ns: int, end_ns: int, spans: list, ranges: tuple = ()) -> Profile:
    """A Profile from kineto events: device operations (user annotations
    mirrored onto the device timeline left out), and for each name in
    ``ranges`` the device seconds of the operations launched from inside a
    CPU range whose name starts with it."""
    ops, windows, launches = [], {r: [] for r in ranges}, []
    for e in events:
        dev = str(e.device_type())
        if dev.endswith("CUDA"):
            if e.is_user_annotation():
                continue
            ops.append(DeviceOp(e.name(), e.start_ns(), e.duration_ns(), _kind(e.name()),
                                e.correlation_id()))
        elif ranges:
            name = e.name()
            for r in ranges:
                if name.startswith(r):
                    windows[r].append((e.start_ns(), e.start_ns() + e.duration_ns()))
            if name.startswith("cuda") and "Launch" in name:
                launches.append((e.start_ns(), e.correlation_id()))
    ops.sort(key=lambda op: op.start_ns)
    by_corr = {}
    for op in ops:
        by_corr.setdefault(op.correlation, []).append(op)
    out_ranges = {}
    for r, wins in windows.items():
        wins.sort()
        starts = [a for a, _b in wins]
        total = 0
        for t, corr in launches:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= wins[i][1]:
                total += sum(op.dur_ns for op in by_corr.get(corr, ()))
        out_ranges[r] = total * 1e-9
    return Profile(ops, start_ns, end_ns, out_ranges, list(spans))
