"""Planner: remote feature rows fetched per iteration (the Trainer's
Σ ``plan.remote_rows_exact`` over the window's epoch)."""


def read(win):
    iters = win.counters.get("iterations", 0)
    rows = win.counters.get("remote_rows")
    return None if not iters or rows is None else rows / iters
