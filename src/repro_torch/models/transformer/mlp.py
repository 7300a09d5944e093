"""Feed-forward variants of the dense transformer family.

The port of the reference's ``models/transformer/mlp.py``:

* ``swiglu``  — llama/mistral/qwen family: silu(x W_g) ⊙ (x W_u) W_d.
* ``sqrelu``  — nemotron-4: relu(x W_u)² W_d (squared-ReLU, 2 matrices).
* ``gelu``    — whisper/ViT classic: gelu(x W_u) W_d, with the tanh
  approximation that ``jax.nn.gelu`` uses by default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.common import init_linear, linear


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype, device=None) -> dict:
    def lin(d_in, d_out):
        return init_linear(generator, d_in, d_out, dtype, device=device)

    if kind == "swiglu":
        return {"wg": lin(d_model, d_ff), "wu": lin(d_model, d_ff),
                "wd": lin(d_ff, d_model)}
    if kind in ("sqrelu", "gelu"):
        return {"wu": lin(d_model, d_ff), "wd": lin(d_ff, d_model)}
    raise ValueError(kind)


def mlp_forward(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return linear(p["wd"], F.silu(linear(p["wg"], x))
                      * linear(p["wu"], x))
    if kind == "sqrelu":
        return linear(p["wd"], torch.square(F.relu(linear(p["wu"], x))))
    if kind == "gelu":
        return linear(p["wd"], F.gelu(linear(p["wu"], x),
                                      approximate="tanh"))
    raise ValueError(kind)
