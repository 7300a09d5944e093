"""GNN layer primitives over tree blocks.

A *tree level pair* is ``(parent, child)`` with shapes
``parent: (n, d_in)``, ``child: (n, f, d_in)`` — children of parent i are
``child[i]``. Every layer maps this pair to updated parent embeddings
``(n, d_out)``.

Each layer is an ``nn.Module`` whose parameters carry the reference's names
and shapes (``repro.models.gnn.layers``), so a JAX parameter tree loads
into it directly (:func:`repro_torch.models.gnn.models.params_from_jax`).
Each ``*_init`` draws a fresh parameter dict from a ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def glorot(generator: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * lim


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """Holds a parameter dict under the reference's names."""

    def __init__(self, params: dict):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))


def gcn_init(generator, d_in, d_out):
    return {"w": glorot(generator, (d_in, d_out)), "b": torch.zeros(d_out)}


class GCN(Layer):
    """Kipf-Welling GCN with mean normalization (self + neighbors)."""

    def forward(self, parent, child):
        f = child.shape[1]
        agg = (parent + child.sum(dim=1)) / (f + 1.0)
        return torch.relu(agg @ self.w + self.b)


def sage_init(generator, d_in, d_out):
    return {"w_self": glorot(generator, (d_in, d_out)),
            "w_nbr": glorot(generator, (d_in, d_out)),
            "b": torch.zeros(d_out)}


class SAGE(Layer):
    """GraphSAGE-mean: act(W_s h_v + W_n mean(h_N(v)))."""

    def forward(self, parent, child):
        return torch.relu(parent @ self.w_self + child.mean(dim=1) @ self.w_nbr
                          + self.b)


def gat_init(generator, d_in, d_out, heads=4):
    if d_out % heads:
        raise ValueError(f"GAT width {d_out} is not a multiple of {heads} "
                         f"heads")
    dh = d_out // heads
    return {"w": glorot(generator, (d_in, heads * dh)),
            "a_src": 0.1 * torch.randn((heads, dh), generator=generator),
            "a_dst": 0.1 * torch.randn((heads, dh), generator=generator)}


class GAT(Layer):
    """GAT: softmax(LeakyReLU(a^T[Wh_i || Wh_j])) attention over sampled
    neighbors (incl. self edge, as DGL does with add_self_loop)."""

    def forward(self, parent, child):
        heads = self.a_src.shape[0]
        n, f, _ = child.shape
        dh = self.w.shape[1] // heads
        hp = (parent @ self.w).reshape(n, heads, dh)
        hc = (child @ self.w).reshape(n, f, heads, dh)
        e_src = torch.einsum("nhd,hd->nh", hp, self.a_src)
        e_dst = torch.einsum("nfhd,hd->nfh", hc, self.a_dst)
        e_self = F.leaky_relu(
            e_src + torch.einsum("nhd,hd->nh", hp, self.a_dst), 0.2)
        e = F.leaky_relu(e_src[:, None, :] + e_dst, 0.2)
        logits = torch.cat([e_self[:, None, :], e], dim=1)    # (n, f+1, h)
        alpha = torch.softmax(logits, dim=1)
        vals = torch.cat([hp[:, None], hc], dim=1)           # (n, f+1, h, dh)
        out = torch.einsum("nfh,nfhd->nhd", alpha, vals).reshape(n, heads * dh)
        return F.elu(out)


def deepgcn_init(generator, d_in, d_out):
    return {"w": glorot(generator, (d_in, d_out)), "b": torch.zeros(d_out),
            "ln_g": torch.ones(d_in), "ln_b": torch.zeros(d_in)}


def _layernorm(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps) * g + b


class DeepGCN(Layer):
    """DeepGCN (ResGCN+): h + W·act(LN(mean-agg)). The residual applies
    when d_in == d_out (hidden layers)."""

    def forward(self, parent, child):
        f = child.shape[1]
        agg = (parent + child.sum(dim=1)) / (f + 1.0)
        y = torch.relu(_layernorm(agg, self.ln_g, self.ln_b)) @ self.w + self.b
        return parent + y if parent.shape[-1] == y.shape[-1] else y


def film_init(generator, d_in, d_out):
    return {"w": glorot(generator, (d_in, d_out)),
            "w_film": glorot(generator, (d_in, 2 * d_out)),
            "b": torch.zeros(d_out)}


class FiLM(Layer):
    """GNN-FiLM: messages W·h_j modulated by FiLM(γ,β) of the target node."""

    def forward(self, parent, child):
        d_out = self.w.shape[1]
        gamma_beta = parent @ self.w_film                    # (n, 2*d_out)
        gamma, beta = gamma_beta[:, :d_out], gamma_beta[:, d_out:]
        msg = child @ self.w                                 # (n, f, d_out)
        mod = gamma[:, None, :] * msg + beta[:, None, :]
        return torch.relu(mod.mean(dim=1) + parent @ self.w + self.b)


# name -> (init_fn, layer class)
LAYER_REGISTRY: dict[str, tuple] = {
    "gcn": (gcn_init, GCN),
    "sage": (sage_init, SAGE),
    "gat": (gat_init, GAT),
    "deepgcn": (deepgcn_init, DeepGCN),
    "film": (film_init, FiLM),
}
