"""Model step: host milliseconds per iteration inside the shards' forward
passes (``model.forward`` spans, one per (shard, step) pass)."""
from bench.metrics._spans import per_iteration_ms


def read(win):
    return per_iteration_ms(win, "model.forward")
