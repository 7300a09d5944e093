"""Full GNN models over tree blocks.

``gnn_forward`` consumes per-hop feature tensors
``feats[h] : (B * f**h, d)`` (h = 0 … k) and returns logits for the B root
vertices. Layer ℓ updates the embeddings of hops 0 … k-ℓ from the pair
(hop h, hop h+1) — DGL's message-flow-graph schedule, re-expressed on the
fixed-fanout tree.

The parameters are a :class:`GNN` module: ``layers[i]`` carries the
reference's per-layer names, and ``head`` its ``w``/``b``. A JAX parameter
tree converts with :func:`params_from_jax` and back with
:func:`params_to_tree`; :meth:`GNN.leaves` lists the tensors in the
reference's ``jax.tree.leaves`` order (``head`` before ``layers``, each
dict by sorted name), which the optimizers and the global norm follow.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.gnn.layers import LAYER_REGISTRY, Layer, glorot


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"            # key in LAYER_REGISTRY
    num_layers: int = 3           # k; paper: 3 shallow, 7 DeepGCN, 10 FiLM
    hidden_dim: int = 128         # paper evaluates 16 and 128
    feature_dim: int = 128
    num_classes: int = 40
    fanout: int = 10              # paper default fanout (§7.1)

    def layer_dims(self) -> list[tuple[int, int]]:
        dims = []
        d = self.feature_dim
        for _ in range(self.num_layers):
            dims.append((d, self.hidden_dim))
            d = self.hidden_dim
        return dims


# Paper model suite (§7.1): 3 shallow (3L) + DeepGCN (7L) + GNN-FiLM (10L).
MODEL_REGISTRY = {
    "gcn": dict(model="gcn", num_layers=3),
    "sage": dict(model="sage", num_layers=3),
    "gat": dict(model="gat", num_layers=3),
    "deepgcn": dict(model="deepgcn", num_layers=7),
    "film": dict(model="film", num_layers=10),
}


class GNN(nn.Module):
    """``layers`` (one per hop of message passing) plus a linear ``head``."""

    def __init__(self, layers: Sequence[Layer], head: dict):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.head = Layer(head)

    def forward(self, feats: Sequence[torch.Tensor], fanout: int
                ) -> torch.Tensor:
        k = len(self.layers)
        if len(feats) != k + 1:
            raise ValueError(f"need {k + 1} hop feature tensors, got "
                             f"{len(feats)}")
        hs = list(feats)
        for layer in self.layers:
            new_hs = []
            for h in range(len(hs) - 1):
                parent = hs[h]
                child = hs[h + 1].reshape(parent.shape[0], fanout,
                                          hs[h + 1].shape[-1])
                new_hs.append(layer(parent, child))
            hs = new_hs
        return hs[0] @ self.head.w + self.head.b

    def leaves(self) -> list:
        """The parameters in the reference's leaf order: the tree
        ``{"head": {"b", "w"}, "layers": [{...}, ...]}`` flattened with its
        dict keys sorted."""
        mods = [self.head, *self.layers]
        return [getattr(m, k) for m in mods for k in sorted(m._parameters)]


def init_gnn(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
             device=None) -> GNN:
    """Fresh parameters drawn from ``generator`` (a CPU generator; default
    seed 0) and placed on ``device`` (default ``cuda``; raises without a
    GPU unless ``device="cpu"``). Draws differ from the reference's
    ``jax.random`` init at the same seed: to hold the two packages against
    each other, convert the reference's tree with :func:`params_from_jax`."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    init_fn, cls = LAYER_REGISTRY[cfg.model]
    layers = [cls(init_fn(g, d_in, d_out)) for d_in, d_out in cfg.layer_dims()]
    head = {"w": glorot(g, (cfg.hidden_dim, cfg.num_classes)),
            "b": torch.zeros(cfg.num_classes)}
    return GNN(layers, head).to(device)


def gnn_forward(params: GNN, cfg: GNNConfig,
                feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """feats[h]: (B*f**h, d_feat) for h in 0..k. Returns (B, n_classes)."""
    if len(params.layers) != cfg.num_layers:
        raise ValueError(f"params have {len(params.layers)} layers, cfg "
                         f"{cfg.num_layers}")
    return params(feats, cfg.fanout)


def gnn_loss(params: GNN, cfg: GNNConfig, feats, labels: torch.Tensor,
             weight: Optional[torch.Tensor] = None):
    """Softmax cross-entropy over the root vertices. Returns (loss, logits).

    Without ``weight`` the loss is the mean. With a (B,) 0/1 ``weight`` —
    padding roots carry 0 — it is the weighted *sum*, and the caller divides
    by the true global batch, so gradients accumulated over time steps equal
    the model-centric gradient (the accuracy-fidelity invariant, §5.1)."""
    logits = gnn_forward(params, cfg, feats)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if weight is None:
        return nll.mean(), logits
    return torch.sum(nll * weight.to(nll.dtype)), logits


def gnn_accuracy(params: GNN, cfg: GNNConfig, feats,
                 labels: torch.Tensor) -> torch.Tensor:
    logits = gnn_forward(params, cfg, feats)
    return (logits.argmax(-1) == labels.long()).float().mean()


def model_param_bytes(params: GNN) -> int:
    """Model size in bytes — denominator of the paper's α ratio (Fig. 5)."""
    return int(sum(p.numel() * p.element_size() for p in params.parameters()))


# parameter names of each layer kind (see layers.*_init) -> the kind
_KIND_BY_NAMES = {
    frozenset({"w", "b"}): "gcn",
    frozenset({"w_self", "w_nbr", "b"}): "sage",
    frozenset({"w", "a_src", "a_dst"}): "gat",
    frozenset({"w", "b", "ln_g", "ln_b"}): "deepgcn",
    frozenset({"w", "w_film", "b"}): "film",
}


def params_from_jax(tree, device=None) -> GNN:
    """Convert the reference's ``init_gnn`` tree
    (``{"layers": [{name: array}], "head": {"w", "b"}}``, arrays as numpy
    or anything ``np.asarray`` takes) into the port's :class:`GNN` on
    ``device`` (default ``cuda``). Each layer's kind follows from its
    parameter names; values are copied exactly."""
    device = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    layers = []
    for i, p in enumerate(tree["layers"]):
        kind = _KIND_BY_NAMES.get(frozenset(p))
        if kind is None:
            raise ValueError(f"layer {i}: parameter names {sorted(p)} match "
                             f"no layer kind")
        layers.append(LAYER_REGISTRY[kind][1]({k: t(v) for k, v in p.items()}))
    head = {k: t(v) for k, v in tree["head"].items()}
    return GNN(layers, head).to(device)


def params_to_tree(params: GNN) -> dict:
    """The inverse of :func:`params_from_jax`: the reference's tree layout
    (``{"layers": [{name: array}], "head": {"w", "b"}}``) with numpy
    float32 copies of the values."""
    def arrays(m):
        return {k: v.detach().cpu().numpy().copy()
                for k, v in m._parameters.items()}
    return {"layers": [arrays(layer) for layer in params.layers],
            "head": arrays(params.head)}


def opt_state_from_jax(state, device=None):
    """Convert the reference's ``AdamState(step, mu, nu)`` (moment trees in
    the parameter tree's layout) into the port's
    :class:`repro_torch.optim.AdamState`: the step as an int32 CPU scalar,
    the moments as float32 tensors on ``device`` (default ``cuda``) in
    :meth:`GNN.leaves` order. Values are copied exactly."""
    from repro_torch.core.distributed import tree_leaves
    from repro_torch.optim import AdamState
    device = resolve_device(device)

    def moments(tree):
        return [torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
                for x in tree_leaves(tree)]
    return AdamState(step=torch.tensor(int(np.asarray(state.step)),
                                       dtype=torch.int32),
                     mu=moments(state.mu), nu=moments(state.nu))
