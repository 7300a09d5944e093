"""Planner: the share of the wall time of the planner's computing spans that
its threads spent off the CPU (jobs, ``plan.account``, and ``plan.dedup``
where it fanned out no job)."""
from bench.metrics._planner import offcpu_pct, planner_compute_spans


def read(win):
    return offcpu_pct(planner_compute_spans(win))
