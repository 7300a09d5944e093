"""Model step: host milliseconds per iteration inside the shards' backward
passes (``model.backward`` spans around ``torch.autograd.grad``)."""
from bench.metrics._spans import per_iteration_ms


def read(win):
    return per_iteration_ms(win, "model.backward")
