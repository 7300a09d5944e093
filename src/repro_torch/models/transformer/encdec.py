"""Whisper-style encoder-decoder backbone.

The port of the reference's ``models/transformer/encdec.py``. The
mel-spectrogram and conv frontend is a stub: the batch carries precomputed
frame embeddings (B, S_enc, D) (``make_batch``). This module is everything
downstream: a bidirectional pre-LN encoder and a causal decoder with cached
self-attention plus cross-attention to the encoder states, with LayerNorm
and GELU (the tanh approximation) and no RoPE. As in the reference, the
decoder adds no positional embedding of its own (ROADMAP.md, Queue 3), and
the decoder's cross-attention in decode runs its scores and softmax in
float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.attention import (
    KVCache, attend_decode, attend_full, cache_append, init_kv_cache)
from repro_torch.models.transformer.common import (
    init_layernorm, init_linear, layernorm, linear, merge_heads, split_heads)


def _init_mha(generator: torch.Generator, d_model: int, dtype,
              device=None) -> dict:
    """Whisper's attention projections: ``wk`` has no bias, ``wq``, ``wv``
    and ``wo`` do."""
    def lin(bias):
        return init_linear(generator, d_model, d_model, dtype, bias=bias,
                           device=device)
    return {"wq": lin(True), "wk": lin(False), "wv": lin(True),
            "wo": lin(True)}


def _mha(p: dict, x_q: torch.Tensor, x_kv: torch.Tensor, heads: int,
         causal: bool) -> torch.Tensor:
    b, sq, d = x_q.shape
    dh = d // heads
    q = split_heads(linear(p["wq"], x_q), heads, dh)
    k = split_heads(linear(p["wk"], x_kv), heads, dh)
    v = split_heads(linear(p["wv"], x_kv), heads, dh)
    o = attend_full(q, k, v, causal=causal)
    return linear(p["wo"], merge_heads(o))


def _ffn(p: dict, h: torch.Tensor) -> torch.Tensor:
    return linear(p["wd"], F.gelu(linear(p["wu"], h), approximate="tanh"))


def init_encoder_layer(generator: torch.Generator, d_model: int, d_ff: int,
                       dtype, device=None) -> dict:
    def lin(d_in, d_out):
        return init_linear(generator, d_in, d_out, dtype, bias=True,
                           device=device)
    return {"ln1": init_layernorm(d_model, dtype, device),
            "attn": _init_mha(generator, d_model, dtype, device),
            "ln2": init_layernorm(d_model, dtype, device),
            "wu": lin(d_model, d_ff), "wd": lin(d_ff, d_model)}


def encoder_layer(p: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    h = layernorm(p["ln1"], x)
    x = x + _mha(p["attn"], h, h, heads, causal=False)
    return x + _ffn(p, layernorm(p["ln2"], x))


def init_decoder_layer(generator: torch.Generator, d_model: int, d_ff: int,
                       dtype, device=None) -> dict:
    def lin(d_in, d_out):
        return init_linear(generator, d_in, d_out, dtype, bias=True,
                           device=device)
    return {"ln1": init_layernorm(d_model, dtype, device),
            "self_attn": _init_mha(generator, d_model, dtype, device),
            "ln_x": init_layernorm(d_model, dtype, device),
            "cross_attn": _init_mha(generator, d_model, dtype, device),
            "ln2": init_layernorm(d_model, dtype, device),
            "wu": lin(d_model, d_ff), "wd": lin(d_ff, d_model)}


def decoder_layer(p: dict, x: torch.Tensor, enc: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """Training / prefill over the whole target sequence."""
    h = layernorm(p["ln1"], x)
    x = x + _mha(p["self_attn"], h, h, heads, causal=True)
    x = x + _mha(p["cross_attn"], layernorm(p["ln_x"], x), enc, heads,
                 causal=False)
    return x + _ffn(p, layernorm(p["ln2"], x))


class DecLayerCache(NamedTuple):
    self_kv: KVCache
    cross_k: torch.Tensor     # (B, S_enc, H, Dh), from the encoder output
    cross_v: torch.Tensor


def init_decoder_cache(p: dict, enc: torch.Tensor, batch: int, max_seq: int,
                       heads: int, d_model: int, dtype) -> DecLayerCache:
    """An empty self-attention cache of ``max_seq`` slots and the layer's
    cross-attention keys and values of ``enc``."""
    dh = d_model // heads
    k = split_heads(linear(p["cross_attn"]["wk"], enc), heads, dh)
    v = split_heads(linear(p["cross_attn"]["wv"], enc), heads, dh)
    return DecLayerCache(
        self_kv=init_kv_cache(batch, max_seq, heads, dh, dtype,
                              device=enc.device),
        cross_k=k, cross_v=v)


def decoder_layer_decode(p: dict, x: torch.Tensor, cache: DecLayerCache,
                         heads: int) -> tuple[torch.Tensor, DecLayerCache]:
    """x: (B, 1, D), one target token."""
    b, _, d = x.shape
    dh = d // heads
    h = layernorm(p["ln1"], x)
    q = split_heads(linear(p["self_attn"]["wq"], h), heads, dh)
    k = split_heads(linear(p["self_attn"]["wk"], h), heads, dh)
    v = split_heads(linear(p["self_attn"]["wv"], h), heads, dh)
    self_kv = cache_append(cache.self_kv, k, v)
    o = attend_decode(q, self_kv)
    x = x + linear(p["self_attn"]["wo"], merge_heads(o))

    hx = layernorm(p["ln_x"], x)
    q = split_heads(linear(p["cross_attn"]["wq"], hx), heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * dh ** -0.5,
                     cache.cross_k.float())
    pzn = torch.softmax(s, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", pzn,
                     cache.cross_v.float()).to(x.dtype)
    x = x + linear(p["cross_attn"]["wo"], merge_heads(o))

    x = x + _ffn(p, layernorm(p["ln2"], x))
    return x, DecLayerCache(self_kv=self_kv, cross_k=cache.cross_k,
                            cross_v=cache.cross_v)
