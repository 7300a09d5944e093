"""Planner: milliseconds per plan in the sampling stage (``plan.sample``
spans: the assignment, pad vertices, labels, sampling and padding)."""
from bench.metrics._planner import stage_ms


def read(win):
    return stage_ms(win, "plan.sample")
