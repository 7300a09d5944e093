"""One reader per per-layer metric, ``<metric>.py``, found by the metric's
name in ``BENCHMARK.json``. Each defines ``read(win) -> float | None`` over
a :class:`bench.harness.Window`; None when it finds nothing to read."""
