"""Trainer loop: the share of the wall time of the ``dispatch`` spans that
the loop's thread spent off the CPU."""
from bench.metrics._planner import complete, offcpu_pct


def read(win):
    return offcpu_pct(complete(win, ("dispatch",)))
