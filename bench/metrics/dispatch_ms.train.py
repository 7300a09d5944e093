"""Trainer loop: host milliseconds per iteration inside the fused step's
dispatch (``dispatch`` spans)."""
from bench.metrics._spans import per_iteration_ms


def read(win):
    return per_iteration_ms(win, "dispatch")
