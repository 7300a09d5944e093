"""Planner: milliseconds per plan in the accounting block (``plan.account``
spans: unique, per-step unique and undeduplicated remote rows)."""
from bench.metrics._planner import stage_ms


def read(win):
    return stage_ms(win, "plan.account")
