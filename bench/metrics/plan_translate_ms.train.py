"""Planner: milliseconds per plan translating the trees into workspace
indices (``plan.translate`` spans, the translation fan-out)."""
from bench.metrics._planner import stage_ms


def read(win):
    return stage_ms(win, "plan.translate")
