"""Queries completed in the window, per second of it (the window runs
from its start to its last completion, common.done)."""


def read(run):
    return run.items_done / run.window_s if run.window_s else None
