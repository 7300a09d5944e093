"""One driver per kind of entry a window drives, ``<driver>.py``, named by
a traffic mix's ``driver`` key. Each defines ``run(cell, *, seed, seconds,
trace, device, t_start) -> (result, compared)``."""
