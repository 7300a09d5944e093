"""Model step and device: milliseconds per plan committing its upload
(``upload.commit`` spans, on the prefetch thread inside ``plan.build``)."""
from bench.metrics._planner import per_plan_ms


def read(win):
    return per_plan_ms(win, "upload.commit")
