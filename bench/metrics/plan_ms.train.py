"""Planner: milliseconds per plan built in the window (``plan.build``
spans on the prefetch thread; each includes its upload commit)."""
from bench.metrics._spans import mean_ms


def read(win):
    return mean_ms(win, "plan.build")
