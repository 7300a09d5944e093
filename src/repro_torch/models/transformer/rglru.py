"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of the reference's ``models/transformer/rglru.py``. The recurrent
branch: a causal depthwise temporal conv (width 4), then the Real-Gated
LRU

    r_t = σ(W_a x_t),  i_t = σ(W_i x_t)
    log a_t = -c · r_t · softplus(Λ)          (c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

gated by a GELU branch (the tanh approximation, ``jax.nn.gelu``'s
default), then projected out. Over a sequence the linear recurrence runs
as a log-depth scan in plain PyTorch (:func:`rglru_scan`), where the
reference runs ``jax.lax.associative_scan``; in decode it is one update.
The scan combines (a, b) pairs and never divides by a cumulative product
of a, which underflows float32 within a few steps (log a_t reaches −17
per step at Λ = 2).

Decode state = (h: (B, W) f32, conv tail: (B, conv_width − 1, W)), the
same size at every position.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.common import (
    _dtensor, from_local_shards, init_linear, linear, rmsnorm,
    to_local_shards)

C_SCALE = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor           # (B, W) f32
    conv: torch.Tensor        # (B, conv_width-1, W)


def init_rglru_block(generator: torch.Generator, cfg, dtype,
                     device=None) -> dict:
    D = cfg.d_model
    W = cfg.rglru_width or D

    def lin(d_in, d_out):
        return init_linear(generator, d_in, d_out, dtype, device=device)

    return {
        "w_in": lin(D, W),                            # recurrent branch in
        "w_gate": lin(D, W),                          # gelu gate branch
        "conv_w": (torch.randn((cfg.conv_width, W), generator=generator,
                               device=device) * 0.1).to(dtype),
        "conv_b": torch.zeros((W,), dtype=dtype, device=device),
        "wa": lin(W, W),                              # recurrence gate
        "wi": lin(W, W),                              # input gate
        "lam": torch.full((W,), 2.0, dtype=torch.float32,
                          device=device),             # Λ (softplus > 0)
        "w_out": lin(W, D),
    }


def _conv1d(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise temporal conv of width cw over x (B, S, W), the
    taps summed in the reference's order. A DTensor runs on each rank's
    (batch, channel) shards: the conv is per channel along the sequence
    (and DTensor plans a pad of a channel-sharded tensor wrongly on some
    torch versions)."""
    if _dtensor(x):
        spec = ("dp", None, "tp")
        local = {"conv_w": to_local_shards(p["conv_w"], None, "tp",
                                           shared=True),
                 "conv_b": to_local_shards(p["conv_b"], "tp", shared=True)}
        return from_local_shards(_conv1d(local, to_local_shards(x, *spec)),
                                 x.device_mesh, x.shape, *spec)
    cw = p["conv_w"].shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = 0
    for i in range(cw):
        out = out + xp[:, i: i + x.shape[1]] * p["conv_w"][i]
    return out + p["conv_b"]


def _gates(p: dict, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, both float32."""
    r = torch.sigmoid(linear(p["wa"], u).float())
    i = torch.sigmoid(linear(p["wi"], u).float())
    log_a = -C_SCALE * r * F.softplus(p["lam"])
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) \
        * (i * u.float())
    return a, gated_in


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, over axis 1: a Hillis–Steele
    scan of ⌈log2 S⌉ doubling steps. Step d folds each position's pair with
    the one d earlier, (a, b) ∘ (a', b') = (a'·a, a·b' + b), the
    reference's associative combine. DTensors scan each rank's (batch,
    channel) shards."""
    if _dtensor(a):
        spec = ("dp", None, "tp")
        return from_local_shards(
            rglru_scan(*(to_local_shards(t, *spec) for t in (a, b))),
            a.device_mesh, a.shape, *spec)
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev = F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        b_prev = F.pad(b[:, :-d], (0, 0, d, 0))
        b = a * b_prev + b
        a = a * a_prev
        d *= 2
    return b


def rglru_block(p: dict, cfg, x: torch.Tensor, norm: dict,
                return_state: bool = False):
    """Full-sequence path. x: (B, S, D). With ``return_state`` also returns
    the RGLRUState after the last token (stateful prefill); a prompt
    shorter than the conv tail leaves zeros before it."""
    h_in = rmsnorm(norm, x)
    gate = F.gelu(linear(p["w_gate"], h_in), approximate="tanh")
    u_proj = linear(p["w_in"], h_in)
    u = _conv1d(p, u_proj)
    a, b = _gates(p, u)
    h = rglru_scan(a, b)
    out = x + linear(p["w_out"], h.to(x.dtype) * gate)
    if return_state:
        cw = p["conv_w"].shape[0]
        tail = F.pad(u_proj, (0, 0, max(cw - 1 - x.shape[1], 0), 0)
                     )[:, -(cw - 1):]
        return out, RGLRUState(h=h[:, -1], conv=tail)
    return out


def init_rglru_state(batch: int, cfg, device=None) -> RGLRUState:
    W = cfg.rglru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, W), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, W),
                         dtype=cfg.activation_dtype, device=device))


def rglru_block_decode(p: dict, cfg, x: torch.Tensor, norm: dict,
                       state: RGLRUState
                       ) -> tuple[torch.Tensor, RGLRUState]:
    """x: (B, 1, D), a single token."""
    h_in = rmsnorm(norm, x)
    gate = F.gelu(linear(p["w_gate"], h_in), approximate="tanh")[:, 0]
    u_t = linear(p["w_in"], h_in)[:, 0]                      # (B, W)
    window = torch.cat([state.conv, u_t[:, None]], 1)
    out = 0
    for i in range(p["conv_w"].shape[0]):
        out = out + window[:, i] * p["conv_w"][i]
    a, b = _gates(p, out + p["conv_b"])
    h = a * state.h + b
    y = linear(p["w_out"], h.to(x.dtype) * gate)
    return x + y[:, None], RGLRUState(h=h, conv=window[:, 1:])
