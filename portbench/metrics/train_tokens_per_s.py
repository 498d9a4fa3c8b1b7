"""Real tokens, queries plus passages, of the training steps completed in
the window, per second of it (the window runs from its start to its last
completion)."""


def read(run):
    return run.tokens_done / run.window_s if run.window_s else None
