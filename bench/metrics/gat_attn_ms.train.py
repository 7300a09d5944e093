"""Model step: host milliseconds per iteration inside GAT's attention
(``gat.attention`` spans: the scores, the softmax, the weighted sum and the
ELU of each pair of hops of each layer's forward)."""
from bench.metrics._spans import per_iteration_ms


def read(win):
    return per_iteration_ms(win, "gat.attention")
