"""What the drivers share: the device's clock and memory, the window's
end, and freeing the program before the reference runs."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def start_window(run, device: str, t_start: float) -> float:
    """Close set-up (everything since the process started) and open the
    measured window: returns its start on ``time.perf_counter``. The heap
    is collected first, so every run enters the window from the same
    state, and the device's peak memory is counted from here."""
    gc.collect()
    sync(device)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    run.window_start_ns = time.time_ns()
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    run.window_t0 = t0
    return t0


def done(run, started: float, finished: float, items: int, tokens: int = 0) -> None:
    """Count a completed call of the window. No call starts after
    ``--seconds``; the window closes when the last call started before then
    completes, every call is counted, and the window's length runs to that
    completion, so a rate is all the work over all the time and is not
    rounded to whole calls."""
    run.items_done += items
    run.tokens_done += tokens
    run.latencies_s.append(finished - started)
    run.window_s = max(run.window_s, finished - run.window_t0)


def close_window(run, device: str) -> None:
    """After the last call of the window has drained: read the peak."""
    sync(device)
    run.mark("window")
    if device != "cpu":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()


def free(device: str) -> None:
    """Give the device's memory back once the caller has dropped the
    program's objects, so the reference has room."""
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def sample(n: int, size: int, gen: np.random.Generator, must=()) -> list[int]:
    """``size`` distinct indices of range(n) drawn from ``gen``, with the
    indices ``must`` among them, sorted."""
    size = min(size, n)
    picked = set(int(i) for i in must)
    for i in gen.permutation(n):
        if len(picked) >= size:
            break
        picked.add(int(i))
    return sorted(picked)


def quantile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
