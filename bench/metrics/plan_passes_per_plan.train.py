"""Planner: planner passes per plan built (``plan.pass`` over ``plan.build``
spans); 1.0 when no probe of a new merge pattern and no rebuild after an
overflow ran."""
from bench.metrics._planner import passes_per_plan


def read(win):
    return passes_per_plan(win)
