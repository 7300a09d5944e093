"""Kernel: ``gather_rows``'s share of its bytes bound in the training
window: the least bytes its gathers need (``bench.counts.gather_bytes``)
over the card's bandwidth, over the summed device time of
``gather_rows_kernel``."""
from bench.metrics._spans import roofline_pct


def read(win):
    return roofline_pct(win, "gather_rows_kernel", "gather_rows_bytes")
