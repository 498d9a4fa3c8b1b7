"""Lightweight metrics + profiling hooks.

The reference has zero observability (SURVEY.md §5: only ad-hoc prints in
tests). This module provides:

- per-operation timing/counter registry (thread-safe), surfaced via each
  database's ``stats()``;
- a ``trace()`` context manager wrapping ``torch.profiler`` for on-demand
  host + device traces (a Chrome trace, viewable in Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict


class Telemetry:
    """Thread-safe op counters + latency accumulators."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = defaultdict(int)
        self._total_s: dict[str, float] = defaultdict(float)
        self._max_s: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def timed(self, op: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
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


@contextlib.contextmanager
def trace(log_dir: str = "minivectordb_tpu_torch_trace"):
    """Capture a torch.profiler trace (host, plus the CUDA device when one is
    present) around a block of work; writes ``<log_dir>/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
