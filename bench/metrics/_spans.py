"""Shared by the readers of the program's spans."""


def per_iteration_ms(win, name: str):
    """Milliseconds of span ``name`` summed over the window, per
    iteration; None without such a span."""
    ns = win.span_ns(name)
    iters = win.counters.get("iterations", 0)
    if not ns or not iters:
        return None
    return sum(ns) / iters / 1e6


def mean_ms(win, name: str):
    ns = win.span_ns(name)
    return sum(ns) / len(ns) / 1e6 if ns else None


def idle_pct(win):
    """100 - the union of the first card's device operations over the
    window, in percent; None when the trace holds no device operation."""
    if not win.ops:
        return None
    return 100.0 * (1.0 - win.busy_ns() / (win.t1_ns - win.t0_ns))


def roofline_pct(win, kernel: str, nbytes_key: str):
    """The bytes bound of ``kernel`` (the window's least bytes over the
    card's memory bandwidth) over its summed device time, in percent."""
    ns = win.op_ns(kernel)
    nbytes = win.counts.get(nbytes_key)
    if not ns or not nbytes or win.peaks is None:
        return None
    return 100.0 * (nbytes / win.peaks["hbm_bytes_per_s"]) / (ns / 1e9)
