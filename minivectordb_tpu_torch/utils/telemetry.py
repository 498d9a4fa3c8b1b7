"""Lightweight metrics + profiling hooks.

The reference has zero observability (SURVEY.md §5: only ad-hoc prints in
tests). This module provides:

- per-operation timing/counter registry (thread-safe), surfaced via each
  database's ``stats()``;
- a span log: ``span(name)`` marks a stretch of the program's host time
  (and with ``device=True`` its device time, by CUDA events) on the clock of
  ``torch.profiler``'s trace (``time.time_ns``), so an idle stretch of the
  device in a trace can be named by what the program was doing then. Spans
  record only while a ``torch.profiler`` runs in the process; otherwise a
  span costs one read of the profiler's flag. ``spans()`` reads the log;
- a ``trace()`` context manager wrapping ``torch.profiler`` for on-demand
  host + device traces (a Chrome trace, viewable in Perfetto), with the
  spans of the traced block on a track of their own.

To see where a request's time goes, run it inside ``trace(log_dir)`` (or any
``torch.profiler``) and read ``spans()``: ``SpanRecord``s of ``(name,
start_ns, end_ns, span_id, parent_id, request_id, thread_id, device_ms)``.
The program's spans are ``search`` (with ``search.filter``, ``search.scan``,
``search.fetch``, ``search.format``; a deferred handle's drain is the root
``search.result`` under its dispatch's request id), ``embed`` (with
``embed.tokenize``, ``embed.device``, ``embed.fetch``, or ``embed.host``) and
the single-card ``train.step`` (with ``train.upload``, ``train.forward``,
``train.backward``, ``train.optimizer``, the last three with device times on
a card). The log keeps the newest 2^20 records; ``spans_dropped()`` counts
those it dropped and ``clear_spans()`` empties it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _profiler

# about 10^6 records; the oldest are dropped (and counted) past it
SPAN_LIMIT = 1 << 20


class Telemetry:
    """Thread-safe op counters + latency accumulators."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = defaultdict(int)
        self._total_s: dict[str, float] = defaultdict(float)
        self._max_s: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def timed(self, op: str, span_name: str | None = None):
        """Count ``op`` and time the block; while spans record, the block is
        also a span named ``span_name`` (``op`` by default)."""
        with span(span_name or op):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(op, time.perf_counter() - t0, count=True)

    def begin(self, op: str):
        """Count ``op`` now and time it to a later point: returns a callable
        that adds the time since this call when first called (a deferred
        search counts at dispatch and is timed to its drain; one never
        drained adds no time)."""
        self.incr(op)
        t0 = time.perf_counter()
        done = []

        def end():
            if not done:
                done.append(True)
                self._add(op, time.perf_counter() - t0, count=False)

        return end

    def _add(self, op: str, dt: float, count: bool):
        with self._lock:
            if count:
                self._counts[op] += 1
            self._total_s[op] += dt
            if dt > self._max_s[op]:
                self._max_s[op] = dt

    def incr(self, op: str, n: int = 1):
        with self._lock:
            self._counts[op] += n

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for op, count in self._counts.items():
                total = self._total_s.get(op, 0.0)
                out[op] = {
                    "count": count,
                    "total_s": round(total, 6),
                    "mean_ms": round(1000 * total / count, 3) if count else 0.0,
                    "max_ms": round(1000 * self._max_s.get(op, 0.0), 3),
                }
            return out

    def reset(self):
        with self._lock:
            self._counts.clear()
            self._total_s.clear()
            self._max_s.clear()


SpanRecord = collections.namedtuple(
    "SpanRecord",
    "name start_ns end_ns span_id parent_id request_id thread_id device_ms",
)
SpanRecord.__doc__ = """One span: its name, start and end in ``time.time_ns``
nanoseconds (the clock of torch.profiler's events), its id, its parent's id
(None for a root), the request id its root started, the thread it ran on,
and the milliseconds of device work between its CUDA events (None without
them)."""


class _Span:
    __slots__ = ("log", "name", "device", "request", "start", "sid",
                 "parent", "events")

    def __init__(self, log, name, device, request):
        self.log, self.name, self.device, self.request = log, name, device, request

    def __enter__(self):
        stack = self.log._stack()
        self.sid = next(self.log._ids)
        if self.request is not None:  # a root that continues a request
            self.parent = None
        elif stack:
            top = stack[-1]
            self.parent, self.request = top.sid, top.request
        else:
            self.parent, self.request = None, next(self.log._requests)
        self.events = None
        if self.device and torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events = [start, None, None]
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events[1] = end
        self.log._stack().pop()
        self.log._append((self.name, self.start, end_ns, self.sid, self.parent,
                          self.request, threading.get_ident(), self.events))
        return False


class SpanLog:
    """A bounded, thread-safe log of spans. Spans nest per thread: one
    opened inside another takes it as parent and shares its request id; a
    root starts a new request id (or continues the one it is given)."""

    def __init__(self, limit: int = SPAN_LIMIT):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._log: collections.deque = collections.deque(maxlen=limit)
        self.dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, rec) -> None:
        with self._lock:
            if len(self._log) == self._log.maxlen:
                self.dropped += 1
            self._log.append(rec)

    def current_request(self) -> int | None:
        """The request id of the innermost span open on this thread, or None."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].request if stack else None

    def records(self) -> list:
        """The log as ``SpanRecord``s in the order the spans closed, each
        span's device milliseconds resolved (waiting for its end event)."""
        with self._lock:
            recs = list(self._log)
        out = []
        for name, start, end, sid, parent, request, thread, events in recs:
            ms = None
            if events is not None and events[1] is not None:
                if events[2] is None:
                    events[1].synchronize()
                    events[2] = events[0].elapsed_time(events[1])
                ms = events[2]
            out.append(SpanRecord(name, start, end, sid, parent, request, thread, ms))
        return out

    def clear(self) -> None:
        """Empty the log and its dropped count."""
        with self._lock:
            self._log.clear()
            self.dropped = 0


_OFF = contextlib.nullcontext()
_LOG = SpanLog()


def span(name: str, device: bool = False, request: int | None = None):
    """A context manager marking the block as span ``name`` of the process's
    span log while a torch.profiler runs; otherwise a shared no-op, at the
    cost of one read of the profiler's flag. ``device=True`` also records a
    CUDA event on the current stream at each edge (on a machine with CUDA),
    from which the record's ``device_ms`` is read. ``request`` makes the
    span a root of that request id (a deferred result drained later, under
    its dispatch's id)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(_LOG, name, device, request)


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def current_request() -> int | None:
    """The request id of the innermost span open on this thread, or None."""
    return _LOG.current_request()


def spans() -> list:
    """The process's span log (``SpanLog.records``)."""
    return _LOG.records()


def spans_dropped() -> int:
    """How many of the oldest spans the log's bound has dropped."""
    return _LOG.dropped


def clear_spans() -> None:
    """Empty the process's span log."""
    _LOG.clear()


# the process id of the spans' track in an exported trace (none of the OS's)
SPAN_TRACK_PID = 1_000_000_000


def _trace_events(records, base_ns: int) -> list:
    """Chrome-trace complete events ("X", microseconds after ``base_ns``) of
    span records, one track per thread under a process of their own."""
    pid = SPAN_TRACK_PID
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "minivectordb_tpu_torch spans"}}]
    for r in records:
        args = {"span_id": r.span_id, "parent_id": r.parent_id, "request_id": r.request_id}
        if r.device_ms is not None:
            args["device_ms"] = r.device_ms
        out.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid, "tid": r.thread_id,
                    "ts": (r.start_ns - base_ns) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
                    "args": args})
    return out


@contextlib.contextmanager
def trace(log_dir: str = "minivectordb_tpu_torch_trace"):
    """Capture a torch.profiler trace (host, plus the CUDA device when one is
    present) around a block of work; writes ``<log_dir>/trace.json``, with
    the spans the block recorded as a track of their own on the trace's
    time base."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    start = time.time_ns()
    with profile(activities=activities) as prof:
        yield log_dir
    end = time.time_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    records = [r for r in spans() if r.start_ns >= start and r.end_ns <= end]
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    doc["traceEvents"] += _trace_events(records, int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
