"""Shared transformer building blocks: inits, linear layers, RMSNorm,
LayerNorm, RoPE and the cross-entropy.

Parameters are plain dicts of tensors, as the reference's are plain dict
pytrees, so a reference tree converts leaf by leaf
(:func:`repro_torch.models.transformer.model.params_from_jax`). A linear
layer keeps the reference's layout ``y = x @ w`` with ``w`` of shape
``(d_in, d_out)``, so weights carry across with no transpose. Random draws
take an explicit ``torch.Generator`` on the device they are drawn on. The
reference's sharding hints (``shard``, ``set_mesh_axes``, ``resolve_axes``)
annotate GSPMD programs and have no counterpart on one card (ROADMAP.md,
Queue 1 item 13).
"""
from __future__ import annotations

from typing import Optional

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


def init_layernorm(d: int, dtype, device=None) -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean and population variance (``jnp.var``'s, not the unbiased one)
    in float32, cast back to x's dtype, then scaled and shifted."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["g"] + p["b"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    """(head_dim / 2,) float32 inverse frequencies, computed on the CPU so
    every device rotates by the same angles."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). The halves
    rotate in float32 and the result is cast back to x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta).to(x.device)                 # (Dh/2,)
    ang = positions[..., None].to(x.device, torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     -1).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL; logits (B, S, V) upcast to float32, labels
    (B, S) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
