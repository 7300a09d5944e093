"""Grouped-query attention with sliding-window and KV-cache support.

The port of the reference's ``models/transformer/attention.py``. Three
entry points:

* ``attend_full``  — training / prefill over a whole sequence. Blockwise
  online softmax over KV chunks, the reference's chunk loop in plain
  PyTorch and in its order of arithmetic: the (S, S) score matrix never
  exists whole.
* ``attend_decode`` — one query token against a (possibly ring-buffered)
  KV cache; the decode path.
* cache helpers — allocate / update caches. Sliding-window configs keep a
  ring buffer of ``window`` slots, slot = position % length.

Keys are RoPE'd at *write* time with absolute positions, queries at read
time. Scores and the accumulator are float32 whatever the storage dtype:
where the reference asks XLA for float32 products of its bf16 operands
(``preferred_element_type``), the port upcasts the operands of each chunk's
products (a bf16 product is exact in float32) and keeps q, k and v in their
storage dtype. GQA heads are grouped in the einsum, never repeated into
memory. The reference's ``shard`` hints stand where it has them: no-ops
on plain tensors, redistributions of DTensors (``common.shard``); the
projections split into heads through ``common.split_heads``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.common import (
    _dtensor, apply_rope, from_local_shards, init_linear, linear,
    merge_heads, shard, split_heads, to_local_shards, tp_size)


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, K, Dh) -> (B, S, K*groups, Dh) by repeating each kv head."""
    if groups == 1:
        return x
    b, s, k, d = x.shape
    return x[:, :, :, None, :].expand(b, s, k, groups, d).reshape(
        b, s, k * groups, d)


def _attend_full_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       **kw) -> torch.Tensor:
    """:func:`attend_full` of DTensors on this rank's shards: the batch
    over dp, the heads over TP where the H query heads divide into its
    shards (else every TP rank attends with all of them), the sequence
    whole. When the K kv heads do not divide into the shards, each is
    repeated r = n / gcd(K, n) times first (the reference's
    ``kv_tp_repeat``, where GSPMD pads instead); values do not change, as
    q head h reads kv head h // (H/K) either way."""
    n = tp_size(q.device_mesh)
    heads = "tp" if q.shape[2] % n == 0 else None
    kh = k.shape[2]
    if heads and kh % n:
        r = n // math.gcd(kh, n)
        k, v = _repeat_kv(k, r), _repeat_kv(v, r)
    spec = ("dp", None, heads, None)
    out = attend_full(*(to_local_shards(t, *spec) for t in (q, k, v)), **kw)
    return from_local_shards(out, q.device_mesh, q.shape, *spec)


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                *, causal: bool = True, window: Optional[int] = None,
                q_offset: int = 0, kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Skv, K, Dh) with H % K == 0.

    Returns (B, Sq, H, Dh) in q's dtype. Online softmax over KV chunks of
    ``kv_chunk`` (the last one padded and the padding masked); causal and
    window masks are applied per chunk, masked scores set to -1e30 and the
    running max started at -inf, as in the reference. ``q_offset`` is the
    absolute position of q[0] relative to k[0] (prefill continuation).
    DTensors attend on each rank's shards (:func:`_attend_full_local`)."""
    if _dtensor(q):
        return _attend_full_local(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, kv_chunk=kv_chunk)
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = dh ** -0.5
    ck = min(kv_chunk, skv)
    nck = -(-skv // ck)
    pad = nck * ck - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    dev = q.device
    q5 = q.reshape(b, sq, kh, g, dh).float()
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, kh, g, sq), -torch.inf, device=dev)
    l = torch.zeros((b, kh, g, sq), device=dev)
    acc = torch.zeros((b, kh, g, sq, dh), device=dev)
    for c in range(nck):
        kc, vc = k[:, c * ck:(c + 1) * ck], v[:, c * ck:(c + 1) * ck]
        kv_pos = c * ck + torch.arange(ck, device=dev)
        s = torch.einsum("bqkgd,bckd->bkgqc", q5, kc.float()) * scale
        mask = kv_pos[None, :] <= (skv - 1)                 # padding
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p.to(v.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]        # (B,K,G,Sq,Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor         # (B, L, K, Dh) — L = min(max_seq, window)
    v: torch.Tensor
    pos: int                # absolute count of tokens written (the
    #                         reference's () int32; a host int here, so a
    #                         decode step reads no device scalar)


def init_kv_cache(batch: int, max_seq: int, kv_heads: int, head_dim: int,
                  dtype, window: Optional[int] = None,
                  device=None) -> KVCache:
    length = min(max_seq, window) if window else max_seq
    shape = (batch, length, kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), pos=0)


def cache_append(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor
                 ) -> KVCache:
    """Append one token (k_new, v_new: (B, 1, K, Dh)) at slot pos % length
    of the ring; returns a new cache and leaves ``cache`` as it was."""
    slot = cache.pos % cache.k.shape[1]
    k, v = cache.k.clone(), cache.v.clone()
    k[:, slot:slot + 1] = k_new
    v[:, slot:slot + 1] = v_new
    return KVCache(k=k, v=v, pos=cache.pos + 1)


def attend_decode(q: torch.Tensor, cache: KVCache, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, H, Dh) for the token at absolute position cache.pos - 1
    (already appended). Attends to every valid cache entry (all of them
    once a ring is full, so ``window`` needs no mask of its own). GQA heads
    are grouped in the einsum."""
    b, _, h, dh = q.shape
    length, kh = cache.k.shape[1], cache.k.shape[2]
    # a DTensor q is gathered over TP (one token's query): the products
    # below merge the batch with the kv heads, and DTensor cannot merge a
    # head dim sharded after the batch's
    q = shard(q, "dp", None, None, None)
    g = h // kh
    scale = dh ** -0.5
    q5 = q.reshape(b, kh, g, dh).float()
    s = torch.einsum("bkgd,bckd->bkgc", q5, cache.k.float()) * scale
    valid = torch.arange(length, device=q.device) < cache.pos
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, -1)
    out = torch.einsum("bkgc,bckd->bkgd", p.to(cache.v.dtype).float(),
                       cache.v.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Full GQA block (projections + rope + attend)
# ---------------------------------------------------------------------------

def init_attn(generator: torch.Generator, cfg, dtype, d_model=None,
              device=None) -> dict:
    D = d_model or cfg.d_model
    dh, H, K = cfg.hdim, cfg.num_heads, cfg.num_kv_heads

    def lin(d_in, d_out, bias):
        return init_linear(generator, d_in, d_out, dtype, bias=bias,
                           device=device)

    return {"wq": lin(D, H * dh, cfg.qkv_bias),
            "wk": lin(D, K * dh, cfg.qkv_bias),
            "wv": lin(D, K * dh, cfg.qkv_bias),
            "wo": lin(H * dh, D, False)}


def attn_forward(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                 window: Optional[int] = None,
                 kv_chunk: int = 1024) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill)."""
    b, s, _ = x.shape
    dh, H, K = cfg.hdim, cfg.num_heads, cfg.num_kv_heads
    q = split_heads(linear(p["wq"], x), H, dh)
    k = split_heads(linear(p["wk"], x), K, dh)
    v = split_heads(linear(p["wv"], x), K, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.kv_tp_repeat > 1:
        # replicate KV heads so the grouped attention shards cleanly on a
        # single (K·rep)-sized head axis across TP; it changes no value
        k = _repeat_kv(k, cfg.kv_tp_repeat)
        v = _repeat_kv(v, cfg.kv_tp_repeat)
        k = shard(k, "dp", None, "tp", None)
        v = shard(v, "dp", None, "tp", None)
        q = shard(q, "dp", None, "tp", None)
    o = attend_full(q, k, v, causal=True, window=window, kv_chunk=kv_chunk)
    return linear(p["wo"], merge_heads(o))


def attn_decode(p: dict, cfg, x: torch.Tensor, cache: KVCache,
                window: Optional[int] = None) -> tuple[torch.Tensor, KVCache]:
    """x: (B, 1, D) single token; returns (out (B, 1, D), updated cache)."""
    b = x.shape[0]
    dh, H, K = cfg.hdim, cfg.num_heads, cfg.num_kv_heads
    pos = torch.full((b, 1), cache.pos, dtype=torch.int32,
                     device=x.device)                       # absolute position
    q = split_heads(linear(p["wq"], x), H, dh)
    k = split_heads(linear(p["wk"], x), K, dh)
    v = split_heads(linear(p["wv"], x), K, dh)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    cache = cache_append(cache, k, v)
    o = attend_decode(q, cache, window=window)
    return linear(p["wo"], merge_heads(o)), cache
