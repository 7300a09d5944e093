"""Device: percent of the training window in which no operation ran on
the first card."""
from bench.metrics._spans import idle_pct


def read(win):
    return idle_pct(win)
