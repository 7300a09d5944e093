"""Model FLOPs of one training iteration.

The trees of R roots with fanout f and k layers have ``R * f**h`` nodes at
hop h. Layer l (0-based) updates hops ``0 .. k - 1 - l`` from their
children at hops ``1 .. k - l``. Counted: every matrix product and
attention contraction the layer equations need, 2 FLOPs per
multiply-add, each operand projected once (GAT's projection of a hop that
is a child in one pair and a parent in the next counts once).
Activations, biases, softmax, the loss and the optimizer are elementwise
and left out, so the count is a lower bound of the work.

A backward pass needs, for each product X @ W, dW = X^T dY and dX = dY
W^T: twice the forward, less dX where X is the raw feature rows of the
first layer, which need no gradient.
"""
from __future__ import annotations


def hop_sizes(roots: int, fanout: int, num_layers: int) -> list:
    return [roots * fanout ** h for h in range(num_layers + 1)]


def _layer(model: dict, n: list, l: int, d_in: int, d_out: int
           ) -> tuple[int, int]:
    """(forward FLOPs, FLOPs of the products whose X is this layer's
    input) of layer ``l`` over hop sizes ``n``."""
    k = model["num_layers"]
    parents = sum(n[: k - l])            # hops 0 .. k-1-l
    if model["kind"] == "sage":
        # h W_self and mean(children) W_nbr at every parent
        mm = 2 * (2 * parents * d_in * d_out)
        return mm, mm
    if model["kind"] == "gat":
        f = model["fanout"]
        nodes = sum(n[: k - l + 1])      # hops 0 .. k-l, each projected once
        proj = 2 * nodes * d_in * d_out
        children = sum(n[1: k - l + 1])
        # a_src . Wh_v and a_dst . Wh_v at each parent, a_dst . Wh_u at
        # each child, then the (f + 1)-term weighted sum at each parent
        attn = 2 * d_out * (2 * parents + children) \
            + 2 * parents * (f + 1) * d_out
        return proj + attn, proj
    raise ValueError(f"no FLOP count for layer kind {model['kind']!r}")


def iteration(model: dict, feature_dim: int, num_classes: int,
              roots: int) -> int:
    """Forward and backward FLOPs of one step over ``roots`` trees."""
    n = hop_sizes(roots, model["fanout"], model["num_layers"])
    total, d_in = 0, feature_dim
    for l in range(model["num_layers"]):
        fwd, first_x = _layer(model, n, l, d_in, model["hidden_dim"])
        # backward: 2x forward, less dX of the products over raw features
        total += fwd + 2 * fwd - (first_x if l == 0 else 0)
        d_in = model["hidden_dim"]
    head = 2 * roots * model["hidden_dim"] * num_classes
    return total + 3 * head

