"""Planner: milliseconds per plan in the dedup stage (``plan.dedup`` spans:
the pregather gather plan, or the per-step gather plans' fan-out)."""
from bench.metrics._planner import stage_ms


def read(win):
    return stage_ms(win, "plan.dedup")
