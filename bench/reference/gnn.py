"""The GNN layer equations, the model over a sampled tree and its loss, in
plain PyTorch.

Parameters are a dict ``{name: tensor}`` with the names ``head.w``,
``head.b`` and ``layers.<i>.<param>``. A tree level pair is ``(parent (n,
d), child (n, f, d))``; layer l updates hops ``0 .. k - 1 - l`` from the
pair (hop h, hop h + 1), and the head maps hop 0 to class logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sage(p: dict, parent: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """GraphSAGE-mean: relu(h_v W_self + mean(h_N(v)) W_nbr + b)."""
    return torch.relu(parent @ p["w_self"] + child.mean(dim=1) @ p["w_nbr"]
                      + p["b"])


def gat(p: dict, parent: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """GAT over the sampled children and a self edge: per head, softmax
    over LeakyReLU_0.2(a_src . Wh_v + a_dst . Wh_u) for u in {v} + N(v),
    the weighted sum of Wh_u, then ELU over the concatenated heads."""
    heads, dh = p["a_src"].shape
    n, f, _ = child.shape
    hp = (parent @ p["w"]).reshape(n, heads, dh)
    hc = (child @ p["w"]).reshape(n, f, heads, dh)
    s = (hp * p["a_src"]).sum(-1)                          # (n, heads)
    e_self = F.leaky_relu(s + (hp * p["a_dst"]).sum(-1), 0.2)
    e_nbr = F.leaky_relu(s[:, None, :] + (hc * p["a_dst"]).sum(-1), 0.2)
    alpha = torch.softmax(torch.cat([e_self[:, None], e_nbr], 1), dim=1)
    vals = torch.cat([hp[:, None], hc], 1)                 # (n, f+1, h, dh)
    out = (alpha[..., None] * vals).sum(1).reshape(n, heads * dh)
    return F.elu(out)


LAYERS = {"sage": sage, "gat": gat}


def layer_params(params: dict, i: int) -> dict:
    pre = f"layers.{i}."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def forward(params: dict, kind: str, num_layers: int, fanout: int,
            feats: list) -> torch.Tensor:
    """feats[h]: (B * fanout**h, d) for h = 0 .. num_layers. Returns the
    (B, classes) logits."""
    layer = LAYERS[kind]
    hs = list(feats)
    for i in range(num_layers):
        p = layer_params(params, i)
        hs = [layer(p, hs[h], hs[h + 1].reshape(hs[h].shape[0], fanout, -1))
              for h in range(len(hs) - 1)]
    return hs[0] @ params["head.w"] + params["head.b"]


def loss(params: dict, kind: str, num_layers: int, fanout: int, feats: list,
         labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the roots."""
    logits = forward(params, kind, num_layers, fanout, feats)
    return F.cross_entropy(logits, labels.long())
