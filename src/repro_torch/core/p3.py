"""Executable P³ baseline [Gandhi & Iyer, OSDI'21] — feature-dimension
model parallelism for the input layer, data parallelism above.

P³ hash-partitions the *feature dimension*: server p stores
``features[:, p·d/N:(p+1)·d/N]`` for every vertex, so raw features never
cross the network. The input layer runs model-parallel — each server
computes a partial first-layer output with its slice and the matching
*rows* of W₁, partials are summed across servers (one activation
all-reduce) — and the remaining layers run data-parallel on the (small)
hidden activations.

A port of the reference's ``repro.core.p3``: the plan is bitwise the
reference's, and the iteration keeps its order of arithmetic (the per-slice
partials are summed with Python's ``sum`` in slice order) with gradients
from ``torch.autograd``. Because a dim-sliced matmul summed over slices
equals the full matmul, P³'s gradients match model-centric training to
float tolerance. Supported models: gcn, sage, gat (the input layer is
matmul-fronted); deepgcn and film normalize *pre-matmul* over the full
feature vector, which P³'s slicing cannot express without an extra
all-gather, and raise :class:`P3Unsupported`.

Feature loads: each hop's rows are read from the full ``(V, d)`` feature
table once per (shard, hop) with ``ops.gather_rows`` — the ``gather_rows``
CUDA kernel on the card, its plain version on the CPU — so an iteration
makes ``(layers + 1) · shards`` loads. The table needs no gradient, so the
forward-only kernel suffices.

Comm accounting mirrors :func:`repro_torch.core.comm_model.p3_bytes`:
hidden activations of hops 0..k-1 cross the fabric (pull + gradient push),
raw features never do.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.graph.sampler import TreeBlock, sample_tree_block
from repro_torch.graph.structs import CSRGraph
from repro_torch.kernels import ops
from repro_torch.models.gnn.layers import LAYER_REGISTRY
from repro_torch.models.gnn.models import GNN, GNNConfig

SUPPORTED = ("gcn", "sage", "gat")


class P3Unsupported(ValueError):
    pass


@dataclasses.dataclass
class P3Plan:
    """Per-model tree blocks with *global* vertex ids (P³ needs no
    owner/local mapping — every server holds every vertex's slice)."""

    blocks: list[TreeBlock]
    labels: list[np.ndarray]
    num_shards: int
    num_layers: int
    fanout: int
    hidden_dim: int

    def activation_bytes(self) -> int:
        """Hidden activations exchanged: hops 0..k-1 unique vertices per
        model, pull + push (×2), (N-1)/N remote share."""
        n = self.num_shards
        total = 0
        for blk in self.blocks:
            for h in range(self.num_layers):
                total += int(np.unique(blk.hops[h]).size)
        return int(2 * total * self.hidden_dim * 4 * (n - 1) / n)


def plan_p3(graph: CSRGraph, labels: np.ndarray,
            roots_per_model: Sequence[np.ndarray], num_layers: int,
            fanout: int, hidden_dim: int,
            sample_seed: int = 0) -> P3Plan:
    blocks, labs = [], []
    for roots in roots_per_model:
        roots = np.asarray(roots, np.int64)
        blocks.append(sample_tree_block(graph, roots, num_layers, fanout,
                                        seed=sample_seed))
        labs.append(labels[roots].astype(np.int32))
    return P3Plan(blocks=blocks, labels=labs,
                  num_shards=len(blocks), num_layers=num_layers,
                  fanout=fanout, hidden_dim=hidden_dim)


# ---------------------------------------------------------------------------
# dim-sliced first layer (the model-parallel piece)
# ---------------------------------------------------------------------------

def _first_layer_partial(model: str, p, parent_x, child_x, d_slice):
    """Partial pre-activation of layer 1 using feature dims ``d_slice``
    and the matching rows of W₁. Summing partials over slices == the full
    computation, so a psum finishes the layer."""
    px = parent_x[:, d_slice]
    cx = child_x[:, :, d_slice]
    if model == "gcn":
        f = cx.shape[1]
        agg = (px + torch.sum(cx, dim=1)) / (f + 1.0)
        return agg @ p.w[d_slice]                         # (n, d_out)
    if model == "sage":
        return (px @ p.w_self[d_slice]
                + torch.mean(cx, dim=1) @ p.w_nbr[d_slice])
    if model == "gat":
        n, f, _ = cx.shape
        hp = px @ p.w[d_slice]                            # (n, h*dh)
        hc = (cx.reshape(n * f, -1) @ p.w[d_slice]).reshape(n, f, -1)
        return torch.cat([hp[:, None], hc], dim=1)        # (n, 1+f, h*dh)
    raise P3Unsupported(model)


def _first_layer_finish(model: str, p, partial_sum, fanout):
    """Post-psum completion of layer 1 (bias, nonlinearity, attention)."""
    if model in ("gcn", "sage"):
        return torch.relu(partial_sum + p.b)
    if model == "gat":
        heads = p.a_src.shape[0]
        n, f1, hd = partial_sum.shape
        dh = hd // heads
        hall = partial_sum.reshape(n, f1, heads, dh)
        hp = hall[:, 0]
        e_src = torch.einsum("nhd,hd->nh", hp, p.a_src)
        e_all = torch.einsum("nfhd,hd->nfh", hall, p.a_dst)
        logits = F.leaky_relu(e_src[:, None, :] + e_all, 0.2)
        alpha = torch.softmax(logits, dim=1)
        out = torch.einsum("nfh,nfhd->nhd", alpha, hall)
        return F.elu(out.reshape(n, heads * dh))
    raise P3Unsupported(model)


def _upper_layers(params: GNN, cfg: GNNConfig, h1_feats):
    """Layers 2..k data-parallel on hidden features (standard tree pass)."""
    _, layer_cls = LAYER_REGISTRY[cfg.model]
    f = cfg.fanout
    hs = list(h1_feats)
    for layer in range(1, cfg.num_layers):
        p = params.layers[layer]
        new_hs = []
        for h in range(len(hs) - 1):
            parent = hs[h]
            d = hs[h + 1].shape[-1]
            child = hs[h + 1].reshape(parent.shape[0], f, d)
            new_hs.append(layer_cls.forward(p, parent, child))
        hs = new_hs
    root = hs[0]
    return root @ params.head.w + params.head.b


def _hop_ids(ids: np.ndarray, num_vertices: int,
             device: torch.device) -> torch.Tensor:
    """One hop's global vertex ids as int32 on ``device``, checked on the
    host against the table height (the gather kernel does no bounds
    check)."""
    ids = np.asarray(ids)
    if ids.size and (ids.min() < 0 or ids.max() >= num_vertices):
        raise IndexError(f"hop ids outside the feature table: range "
                         f"[{ids.min()}, {ids.max()}], {num_vertices} rows")
    return torch.from_numpy(ids.astype(np.int32)).to(device)


def run_p3_iteration(params: GNN, features, plan: P3Plan, cfg: GNNConfig,
                     device=None):
    """Execute one P³ iteration (emulated comm: the per-slice partial sums
    make the model-parallel schedule explicit; a multi-device realization
    replaces the Python sum with an all-reduce over the dim axis).

    ``features`` is the full ``(V, d)`` feature table: a tensor (the
    iteration runs on its device) or an array, uploaded to ``device``
    (default ``cuda``); ``params`` must live on the same device. Returns
    ``(grads, mean_loss)`` with the grads in :meth:`GNN.leaves` order, as
    :func:`repro_torch.core.distributed.run_iteration` returns them."""
    if cfg.model not in SUPPORTED:
        raise P3Unsupported(
            f"{cfg.model}: P³'s input-layer slicing needs a matmul-fronted "
            f"layer (paper §1: P³ targets particular GNN shapes)")
    if not isinstance(features, torch.Tensor):
        features = torch.from_numpy(np.ascontiguousarray(features)).to(
            resolve_device(device))
    dev = features.device
    n = plan.num_shards
    d = cfg.feature_dim
    k = cfg.num_layers
    # the reference's np.array_split(np.arange(d), n) slices, as views
    edges = np.cumsum([0] + [ix.size for ix in
                             np.array_split(np.arange(d), n)])
    slices = [slice(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]
    total_roots = sum(len(lab) for lab in plan.labels)
    p0 = params.layers[0]

    loss_sum = 0.0
    for s in range(n):
        blk = plan.blocks[s]
        # each hop's rows, loaded once for this shard
        xs = [ops.gather_rows(features,
                              _hop_ids(ids, features.shape[0], dev))
              for ids in blk.hops]
        # layer 1, model-parallel: partial per dim slice, then "psum"
        h1 = []
        for h in range(k):
            parent_x = xs[h]
            child_x = xs[h + 1].reshape(blk.hops[h].shape[0], cfg.fanout, d)
            partial = sum(_first_layer_partial(cfg.model, p0, parent_x,
                                               child_x, sl)
                          for sl in slices)
            h1.append(_first_layer_finish(cfg.model, p0, partial,
                                          cfg.fanout))
        logits = _upper_layers(params, cfg, h1)
        labs = torch.from_numpy(plan.labels[s]).to(dev)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, labs.long()[:, None])[:, 0]
        loss_sum = loss_sum + nll.sum()
    loss = loss_sum / total_roots
    grads = torch.autograd.grad(loss, params.leaves())
    return list(grads), loss.detach()
