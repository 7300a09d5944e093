"""Shared transformer building blocks: inits, linear layers, RMSNorm.

Parameters are plain dicts of tensors, as the reference's are plain dict
pytrees, so a reference tree converts leaf by leaf
(:func:`repro_torch.models.transformer.model.params_from_jax`). A linear
layer keeps the reference's layout ``y = x @ w`` with ``w`` of shape
``(d_in, d_out)``, so weights carry across with no transpose. Random draws
take an explicit ``torch.Generator`` on the device they are drawn on. The
reference's sharding hints and RoPE have no counterpart here yet: the port
runs on one card, and RWKV6 has no positional rotation.
"""
from __future__ import annotations

import torch


def he_normal(generator: torch.Generator, shape, dtype, fan_in=None,
              device=None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    x = torch.randn(shape, generator=generator, device=device)
    return (x * (2.0 / fan) ** 0.5).to(dtype)


def init_linear(generator: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False, device=None) -> dict:
    p = {"w": he_normal(generator, (d_in, d_out), dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_rmsnorm(d: int, dtype, device=None) -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32, cast back to x's dtype, then scaled."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p["g"]
