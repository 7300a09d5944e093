"""Shared by the readers of the planner's pass, stage and job spans and of
the CPU time the program records on every span (``cpu_ns``, the recording
thread's CPU time between the span's enter and exit)."""
import bisect

# the per-item spans of the planner's fan-outs, on whichever thread runs them
JOBS = ("plan.sample.job", "plan.translate.job", "plan.dedup.job")


def per_plan_ms(win, name: str):
    """Milliseconds of span ``name`` summed over the window, over the
    window's ``plan.build`` spans; None without either."""
    plans = len(win.span_ns("plan.build"))
    ns = win.span_ns(name)
    if not plans or not ns:
        return None
    return sum(ns) / plans / 1e6


def stage_ms(win, name: str):
    """:func:`per_plan_ms` of a planner stage span. Stage spans come with
    ``plan.pass`` spans: a program that records no passes has no stage
    spans (its ``plan.sample`` named the sampling jobs), so None there."""
    if not win.span_ns("plan.pass"):
        return None
    return per_plan_ms(win, name)


def passes_per_plan(win):
    """``plan.pass`` spans over ``plan.build`` spans; None without either."""
    plans = len(win.span_ns("plan.build"))
    passes = len(win.span_ns("plan.pass"))
    if not plans or not passes:
        return None
    return passes / plans


def complete(win, names) -> list:
    return [r for r in win.spans if r.kind == "X" and r.name in names]


def planner_compute_spans(win) -> list:
    """The spans in which the planner computes rather than waits on its
    pool: every job, every ``plan.account``, and every ``plan.dedup`` that
    no ``plan.dedup.job`` starts inside (pregather mode, where the dedup
    runs on the building thread). Stages that fanned out are left out."""
    jobs = complete(win, JOBS)
    starts = sorted(r.t0_ns for r in jobs if r.name == "plan.dedup.job")
    own = []
    for r in complete(win, ("plan.dedup",)):
        i = bisect.bisect_left(starts, r.t0_ns)
        if i == len(starts) or starts[i] > r.t1_ns:
            own.append(r)
    return jobs + complete(win, ("plan.account",)) + own


def offcpu_pct(spans: list):
    """100 × Σ(wall − CPU time) / Σ wall over ``spans``: the share of their
    wall time the threads spent off the CPU (waiting for the GIL, a lock,
    a future or the scheduler). None without spans, or where a span
    carries no CPU time (a program that does not record it)."""
    if not spans or any(getattr(r, "cpu_ns", None) is None for r in spans):
        return None
    wall = sum(r.t1_ns - r.t0_ns for r in spans)
    if wall <= 0:
        return None
    return 100.0 * sum(r.t1_ns - r.t0_ns - r.cpu_ns for r in spans) / wall
