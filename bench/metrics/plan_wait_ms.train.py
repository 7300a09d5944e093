"""Trainer loop: milliseconds per iteration the loop waits for the next
plan (``plan.wait`` spans on the main thread)."""
from bench.metrics._spans import per_iteration_ms


def read(win):
    return per_iteration_ms(win, "plan.wait")
