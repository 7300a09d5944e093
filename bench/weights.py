"""Random model weights from ``--seed``, made on the device in two draws.

Matrices are Glorot-uniform, GAT's attention vectors 0.1 * N(0, 1), biases
zero. The same tensors go to the program and to the reference."""
from __future__ import annotations

import math

import torch


def shapes(model: dict, feature_dim: int, num_classes: int) -> dict:
    """{name: (shape, kind)} with kind "glorot", "normal" or "zeros"."""
    out = {"head.b": ((num_classes,), "zeros"),
           "head.w": ((model["hidden_dim"], num_classes), "glorot")}
    d_in = feature_dim
    for i in range(model["num_layers"]):
        d_out = model["hidden_dim"]
        pre = f"layers.{i}."
        if model["kind"] == "sage":
            out[pre + "b"] = ((d_out,), "zeros")
            out[pre + "w_nbr"] = ((d_in, d_out), "glorot")
            out[pre + "w_self"] = ((d_in, d_out), "glorot")
        elif model["kind"] == "gat":
            heads = model["heads"]
            out[pre + "a_dst"] = ((heads, d_out // heads), "normal")
            out[pre + "a_src"] = ((heads, d_out // heads), "normal")
            out[pre + "w"] = ((d_in, d_out), "glorot")
        else:
            raise ValueError(f"no weights for layer kind {model['kind']!r}")
        d_in = d_out
    return out


def make(model: dict, feature_dim: int, num_classes: int, seed: int,
         device) -> dict:
    spec = shapes(model, feature_dim, num_classes)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n_u = sum(math.prod(s) for s, k in spec.values() if k == "glorot")
    n_z = sum(math.prod(s) for s, k in spec.values() if k == "normal")
    u = torch.rand(n_u, generator=g, device=device)
    z = torch.randn(max(n_z, 1), generator=g, device=device)
    out, iu, iz = {}, 0, 0
    for name, (shape, kind) in spec.items():
        n = math.prod(shape)
        if kind == "glorot":
            lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            out[name] = ((u[iu:iu + n] * 2.0 - 1.0) * lim).reshape(shape)
            iu += n
        elif kind == "normal":
            out[name] = (0.1 * z[iz:iz + n]).reshape(shape)
            iz += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
