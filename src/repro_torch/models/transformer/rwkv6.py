"""RWKV6 ("Finch") block — attention-free, data-dependent decay.

The port of the reference's ``models/transformer/rwkv6.py``. Per layer: a
*time-mix* block (token-shift lerp → r/k/v/g projections, a LoRA-conditioned
per-channel decay w_t, the gated-linear-attention core from
:mod:`repro_torch.kernels.ops` with per-head state, group-norm, silu(g)
gate) and a *channel-mix* block (token-shift, squared-ReLU FFN with sigmoid
receptance).

Prefill runs the chunked linear attention over the whole prompt — on CUDA
the hand-written kernel — and decode carries (state (B, H, dk, dv) f32,
last x per mix), constant-size per token. As in the reference, the decay w
and the attention's r, k, v are float32 whatever the model's dtype, and the
attention's output is cast back to the model's dtype before the group norm.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.transformer.common import (
    _dtensor, from_local_shards, init_linear, linear, rmsnorm,
    to_local_shards, tp_size)


class RWKVState(NamedTuple):
    s: torch.Tensor         # (B, H, dk, dv) f32 — linattn state
    tm_x: torch.Tensor      # (B, D) — last token seen by time-mix
    cm_x: torch.Tensor      # (B, D) — last token seen by channel-mix


def init_rwkv_block(generator: torch.Generator, cfg, dtype, device) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    hd = cfg.rwkv_head_dim
    H = D // hd
    lora = 64

    def lin(d_in, d_out):
        return init_linear(generator, d_in, d_out, dtype, device=device)

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        # time-mix
        "mu": full((5, D), 0.5),                     # lerp for r,k,v,g,w
        "wr": lin(D, D), "wk": lin(D, D), "wv": lin(D, D), "wg": lin(D, D),
        "wo": lin(D, D),
        "w_base": full((D,), -6.0, torch.float32),   # decay bias (≈ w→1)
        "w_lora_a": lin(D, lora), "w_lora_b": lin(lora, D),
        "u": full((H, hd), 0.0, torch.float32),      # per-head bonus
        "gn_g": full((D,), 1.0), "gn_b": full((D,), 0.0),
        # channel-mix
        "mu_c": full((2, D), 0.5),
        "ck": lin(D, Fd), "cr": lin(D, D), "cv": lin(Fd, D),
    }


def _group_norm(x, g, b, heads: int, eps: float = 1e-5):
    """Per-head norm in float32 with the population variance."""
    B, S, D = x.shape
    xh = x.reshape(B, S, heads, D // heads).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return xh.reshape(B, S, D).to(x.dtype) * g + b


def _decay(p, xw):
    """Data-dependent per-channel decay w_t ∈ (0, 1), near 1, in float32."""
    lora = linear(p["w_lora_b"], torch.tanh(linear(p["w_lora_a"], xw)))
    return torch.exp(-torch.exp(p["w_base"] + lora.float()))


def _timemix_inputs(p, x, x_prev):
    """Token-shift lerp for each of r,k,v,g,w. x_prev: x shifted right."""
    mu = p["mu"]
    return [x + (x_prev - x) * mu[i] for i in range(5)]


def _chunk(S: int) -> int:
    """The reference's chunk: 64 where it divides S, S below 64, else 1."""
    return 64 if S % 64 == 0 else (S if S < 64 else 1)


def _linattn_heads(r, k, v, w, u, state_s, S: int):
    """The linear attention of r, k, v, w (B, S, H, hd) with bonus u (H,
    hd) from state_s (B, H, hd, hd) or zeros: (o (B, S, H, hd) float32,
    state (B, H, hd, hd)). DTensors run on each rank's (batch, head)
    shards: the batch over dp, the heads over TP where they divide."""
    if _dtensor(r):
        mesh = r.device_mesh
        heads = "tp" if r.shape[2] % tp_size(mesh) == 0 else None
        spec = ("dp", None, heads, None)
        o, s_new = _linattn_heads(
            *(to_local_shards(t, *spec) for t in (r, k, v, w)),
            to_local_shards(u, heads, None, shared=True),
            None if state_s is None
            else to_local_shards(state_s, "dp", heads, None, None), S)
        B, _, H, hd = r.shape
        return (from_local_shards(o, mesh, (B, S, H, hd), *spec),
                from_local_shards(s_new, mesh, (B, H, hd, hd), "dp", heads,
                                  None, None))
    B, _, H, hd = r.shape

    def to_bh(t):  # (B,S,H,hd) -> (B*H, S, hd) float32, contiguous
        return t.permute(0, 2, 1, 3).reshape(B * H, S, hd).float() \
            .contiguous()

    o, s_new = ops.linattn(to_bh(r), to_bh(k), to_bh(v), to_bh(w),
                           u.repeat(B, 1),                 # (B*H, hd)
                           state=(state_s.reshape(B * H, hd, hd)
                                  if state_s is not None else None),
                           chunk=_chunk(S))
    return (o.reshape(B, H, S, hd).permute(0, 2, 1, 3),
            s_new.reshape(B, H, hd, hd))


def rwkv_timemix(p, cfg, x, x_prev, state_s: Optional[torch.Tensor]):
    """x: (B,S,D); x_prev: right-shifted x; state_s: (B,H,dk,dv) or None."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    xr, xk, xv, xg, xw = _timemix_inputs(p, x, x_prev)
    r = linear(p["wr"], xr).reshape(B, S, H, hd)
    k = linear(p["wk"], xk).reshape(B, S, H, hd)
    v = linear(p["wv"], xv).reshape(B, S, H, hd)
    g = linear(p["wg"], xg)
    w = _decay(p, xw).reshape(B, S, H, hd)

    o, s_new = _linattn_heads(r, k, v, w, p["u"], state_s, S)
    o = o.reshape(B, S, D)
    o = _group_norm(o.to(x.dtype), p["gn_g"], p["gn_b"], H)
    out = linear(p["wo"], o * F.silu(g))
    return out, s_new


def rwkv_channelmix(p, x, x_prev):
    mu = p["mu_c"]
    xk = x + (x_prev - x) * mu[0]
    xr = x + (x_prev - x) * mu[1]
    kk = torch.square(torch.relu(linear(p["ck"], xk)))
    return torch.sigmoid(linear(p["cr"], xr)) * linear(p["cv"], kk)


def _shift_right(x):
    """x shifted one position right along the sequence, zeros first; a
    DTensor on each rank's (batch, channel) shards (DTensor plans a pad
    of a channel-sharded tensor wrongly on some torch versions)."""
    if _dtensor(x):
        spec = ("dp", None, "tp")
        return from_local_shards(_shift_right(to_local_shards(x, *spec)),
                                 x.device_mesh, x.shape, *spec)
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv_block(p, cfg, x, norms, return_state: bool = False):
    """Full-sequence prefill. norms = (ln1, ln2) rmsnorm params. With
    ``return_state`` also returns the RWKVState after the last token."""
    h = rmsnorm(norms[0], x)
    tm, s_new = rwkv_timemix(p, cfg, h, _shift_right(h), None)
    tm_x_last = h[:, -1]
    x = x + tm
    h2 = rmsnorm(norms[1], x)
    x = x + rwkv_channelmix(p, h2, _shift_right(h2))
    if return_state:
        return x, RWKVState(s=s_new, tm_x=tm_x_last, cm_x=h2[:, -1])
    return x


def _linattn_step_heads(r, k, v, w, u, s):
    """One decode step of the linear attention on DTensors r, k, v, w
    (B, H, hd) with state s (B, H, hd, hd), on each rank's (batch, head)
    shards: (o (B, H, hd), new state). Flattening (B, H) would merge two
    sharded dims, which DTensor refuses."""
    mesh = r.device_mesh
    B, H, hd = r.shape
    heads = "tp" if H % tp_size(mesh) == 0 else None
    rl, kl, vl, wl = (to_local_shards(t, "dp", heads, None)
                      for t in (r, k, v, w))
    bl, hl = rl.shape[:2]
    o, s_new = ops.linattn_step(
        *(t.reshape(bl * hl, hd).float() for t in (rl, kl, vl)),
        wl.reshape(bl * hl, hd),
        to_local_shards(u, heads, None, shared=True).repeat(bl, 1),
        to_local_shards(s, "dp", heads, None, None).reshape(bl * hl, hd,
                                                            hd))
    return (from_local_shards(o.reshape(bl, hl, hd), mesh, (B, H, hd),
                              "dp", heads, None),
            from_local_shards(s_new.reshape(bl, hl, hd, hd), mesh,
                              (B, H, hd, hd), "dp", heads, None, None))


def rwkv_block_decode(p, cfg, x, norms, state: RWKVState):
    """x: (B, 1, D) one token; returns (x, new_state)."""
    B, _, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    h = rmsnorm(norms[0], x)
    h_prev = state.tm_x[:, None, :]
    xr, xk, xv, xg, xw = _timemix_inputs(p, h, h_prev)
    g = linear(p["wg"], xg)
    if _dtensor(x):
        o, s_new = _linattn_step_heads(
            *(t.reshape(B, H, hd) for t in (linear(p["wr"], xr),
                                            linear(p["wk"], xk),
                                            linear(p["wv"], xv),
                                            _decay(p, xw))),
            p["u"], state.s)
        o = o.reshape(B, 1, D).to(x.dtype)
    else:
        r = linear(p["wr"], xr).reshape(B * H, hd)
        k = linear(p["wk"], xk).reshape(B * H, hd)
        v = linear(p["wv"], xv).reshape(B * H, hd)
        w = _decay(p, xw).reshape(B * H, hd)
        o, s_new = ops.linattn_step(r.float(), k.float(), v.float(), w,
                                    p["u"].repeat(B, 1),
                                    state.s.reshape(B * H, hd, hd))
        o = o.reshape(B, 1, D).to(x.dtype)
    o = _group_norm(o, p["gn_g"], p["gn_b"], H)
    x = x + linear(p["wo"], o * F.silu(g))
    tm_x_new = h[:, 0]

    h2 = rmsnorm(norms[1], x)
    x = x + rwkv_channelmix(p, h2, state.cm_x[:, None, :])
    return x, RWKVState(s=s_new.reshape(B, H, hd, hd),
                        tm_x=tm_x_new, cm_x=h2[:, 0])
