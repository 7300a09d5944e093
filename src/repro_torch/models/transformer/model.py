"""Model assembly for the transformer side workload — the ``dense`` and
``ssm`` families.

The port of the reference's ``models/transformer/model.py`` for dense GQA
(with sliding window and KV cache) and RWKV6:

  * ``init_params(cfg, generator, device)`` — seeded random parameters
  * ``forward(params, cfg, batch)``         — full logits (+ aux)
  * ``loss_fn(params, cfg, batch)``         — next-token CE (+ aux)
  * ``prefill(params, cfg, batch, max_seq)`` — last-token logits + state
  * ``init_decode_state(cfg, batch, max_seq, device)`` — empty caches
  * ``decode_step(params, cfg, token, state)`` — one-token serve step
  * ``params_from_jax(tree, cfg, device)`` — the reference's tree, converted

Parameters are plain dicts of tensors in the reference's tree layout, except
that ``layers`` is a list of per-layer dicts (the reference stacks them on a
leading axis for ``lax.scan``); layers run as a Python loop, each under
``torch.utils.checkpoint`` when autograd records (the reference's
``jax.checkpoint`` of the layer body: full remat per layer). The decode
state's ``caches`` is likewise a list: a ``KVCache`` per dense layer, an
``RWKVState`` per RWKV6 layer. The other families (moe, hybrid, audio,
vlm) raise ``NotImplementedError`` until they are ported (ROADMAP.md,
Queue 1 item 9). The reference's dry-run knobs (``set_remat_policy``,
``set_scan_unroll``, ``set_sequence_sharding``) belong to its GSPMD
programs and have no counterpart here (Queue 1 item 13).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.transformer.attention import (
    KVCache, attn_decode, attn_forward, init_attn, init_kv_cache)
from repro_torch.models.transformer.common import (apply_rope, init_rmsnorm,
                                                   linear, rmsnorm)
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.mlp import init_mlp, mlp_forward
from repro_torch.models.transformer.rwkv6 import (
    RWKVState, init_rwkv_block, rwkv_block, rwkv_block_decode)

# leaves the reference keeps in float32 whatever the model's dtype
_F32_LEAVES = ("w_base", "u")
PORTED_FAMILIES = ("dense", "ssm")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.moe_num_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}"
            f"{', with MoE layers' if cfg.moe_num_experts else ''}) is not "
            f"ported yet (ROADMAP.md, Queue 1 item 9); the port runs "
            f"{' and '.join(repr(f) for f in PORTED_FAMILIES)}")


class DecodeState(NamedTuple):
    caches: Any             # list of per-layer KVCache (dense) or RWKVState


def _ckpt(fn, *args):
    """``fn(*args)``, recomputed in the backward pass instead of saved when
    autograd records (non-reentrant ``torch.utils.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ===========================================================================
# init
# ===========================================================================

def _init_dense_layer(g, cfg: ArchConfig, dtype, device) -> dict:
    return {"ln1": init_rmsnorm(cfg.d_model, dtype, device),
            "attn": init_attn(g, cfg, dtype, device=device),
            "ln2": init_rmsnorm(cfg.d_model, dtype, device),
            "mlp": init_mlp(g, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device)}


def _init_rwkv_layer(g, cfg: ArchConfig, dtype, device) -> dict:
    return {"ln1": init_rmsnorm(cfg.d_model, dtype, device),
            "ln2": init_rmsnorm(cfg.d_model, dtype, device),
            "blk": init_rwkv_block(g, cfg, dtype, device)}


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random parameters drawn on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``) from ``generator``, which must
    live on that device (default: seed 0). The draws differ from the
    reference's ``jax.random`` ones; to hold the two packages against each
    other, convert the reference's tree with :func:`params_from_jax`."""
    _require_ported(cfg)
    device = resolve_device(device)
    g = generator if generator is not None \
        else torch.Generator(device=device).manual_seed(0)
    dtype = cfg.activation_dtype
    D, V = cfg.d_model, cfg.padded_vocab

    def normal(shape):
        return (torch.randn(shape, generator=g, device=device) * 0.02
                ).to(dtype)

    p: dict[str, Any] = {"embed": normal((V, D)),
                         "norm_f": init_rmsnorm(D, dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = normal((D, V))
    init_layer = _init_dense_layer if cfg.family == "dense" \
        else _init_rwkv_layer
    p["layers"] = [init_layer(g, cfg, dtype, device)
                   for _ in range(cfg.num_layers)]
    return p


def params_from_jax(tree: dict, cfg: ArchConfig, device) -> dict:
    """The reference's ``init_params`` tree (numpy or JAX arrays, layer
    leaves stacked on a leading ``L`` axis) as the port's parameters on
    ``device``: RWKV6's ``w_base`` and ``u`` in float32, every other leaf
    in ``cfg``'s dtype. Leaves pass through float32, which holds bfloat16
    exactly, so values copy exactly."""
    _require_ported(cfg)
    device = torch.device(device)
    dtype = cfg.activation_dtype

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        return t.to(device, torch.float32 if name in _F32_LEAVES else dtype)

    def pick(node, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in node.items()}

    out = walk({k: v for k, v in tree.items() if k != "layers"})
    stacked = walk(tree["layers"])
    n = stacked["ln1"]["g"].shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"tree has {n} layers, cfg {cfg.num_layers}")
    out["layers"] = [pick(stacked, i) for i in range(n)]
    return out


# ===========================================================================
# layer body and forward (train / prefill logits)
# ===========================================================================

def _dense_layer_fwd(layer_p, cfg: ArchConfig, x, positions):
    h = rmsnorm(layer_p["ln1"], x)
    x = x + attn_forward(layer_p["attn"], cfg, h, positions,
                         window=cfg.swa_window)
    h = rmsnorm(layer_p["ln2"], x)
    return (x + mlp_forward(layer_p["mlp"], h, cfg.mlp),
            torch.zeros((), device=x.device))


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    return emb[tokens.to(emb.device, torch.long)]


def _head_matrix(params):
    head = params.get("head")
    return head if head is not None else params["embed"].T


def forward_hidden(params, cfg: ArchConfig, batch: dict
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Backbone only: returns (final-normed hidden (B, S, D), aux_loss).
    ``batch`` is ``{"tokens": (B, S) int}`` for both ported families."""
    _require_ported(cfg)
    x = _embed(params, batch["tokens"])
    aux = torch.zeros((), device=x.device)
    if cfg.family == "dense":
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in params["layers"]:
            x, a = _ckpt(_dense_layer_fwd, layer, cfg, x, positions)
            aux = aux + a
    else:
        for layer in params["layers"]:
            x = _ckpt(rwkv_block, layer["blk"], cfg, x,
                      (layer["ln1"], layer["ln2"]))
    return rmsnorm(params["norm_f"], x), aux


def forward(params, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full logits (B, S, V_padded) and the aux loss (0 for both ported
    families) — the serving/debug path. Training goes through
    :func:`loss_fn` (chunked CE; full-sequence float32 logits never
    exist)."""
    x, aux = forward_hidden(params, cfg, batch)
    return x @ _head_matrix(params), aux


# ===========================================================================
# training loss
# ===========================================================================

def _labels_and_mask(cfg: ArchConfig, batch: dict, S: int, device):
    """Next-token labels aligned to hidden positions, with a validity mask
    (the last position has no next token). The vlm branch, whose patch
    prefix is unsupervised, arrives with that family."""
    if cfg.family == "vlm":
        raise NotImplementedError("vlm labels are not ported yet (ROADMAP.md,"
                                  " Queue 1 item 9)")
    tokens = batch["tokens"].to(device)
    B = tokens.shape[0]
    labels = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], 1)
    mask = (torch.arange(S, device=device) < S - 1)[None].expand(B, S)
    return labels, mask


def _ce_chunk(W, xc, lc, mc):
    logits = (xc @ W).float()                       # (B, C, V)
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, lc[..., None].long())[..., 0]
    m = mc.float()
    return ((logz - gold) * m).sum(), m.sum()


def chunked_ce(params, x: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over sequence chunks of ``chunk`` positions, each
    recomputed in the backward pass: the (B, S, V) float32 logits never
    exist — only one chunk's (B, C, V) at a time. S is padded to a
    multiple of C (padding masked), and the chunks' sums accumulate in
    order, as the reference's scan carries them."""
    W = _head_matrix(params)
    B, S, D = x.shape
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    s_nll = torch.zeros((), device=x.device)
    s_cnt = torch.zeros((), device=x.device)
    for c0 in range(0, x.shape[1], C):
        nll, cnt = _ckpt(_ce_chunk, W, x[:, c0:c0 + C],
                         labels[:, c0:c0 + C], mask[:, c0:c0 + C])
        s_nll = s_nll + nll
        s_cnt = s_cnt + cnt
    return s_nll / torch.clamp(s_cnt, min=1.0)


def loss_fn(params, cfg: ArchConfig, batch: dict,
            aux_weight: float = 0.01) -> tuple[torch.Tensor, dict]:
    """(total, {"ce", "aux"}): the mean next-token CE plus ``aux_weight``
    times the aux loss (zero for dense and ssm; MoE's balance loss arrives
    with that family)."""
    x, aux = forward_hidden(params, cfg, batch)
    labels, mask = _labels_and_mask(cfg, batch, x.shape[1], x.device)
    ce = chunked_ce(params, x, labels, mask)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ===========================================================================
# decode
# ===========================================================================

def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      device=None) -> DecodeState:
    """Empty per-layer caches: a KV cache of ``min(max_seq, swa_window)``
    slots per dense layer; a zero state per RWKV6 layer, whose state does
    not grow with the sequence (``max_seq`` unused)."""
    _require_ported(cfg)
    device = resolve_device(device)
    dtype = cfg.activation_dtype
    if cfg.family == "dense":
        def one():
            return init_kv_cache(batch, max_seq, cfg.num_kv_heads, cfg.hdim,
                                 dtype, window=cfg.swa_window, device=device)
    else:
        hd = cfg.rwkv_head_dim
        H = cfg.d_model // hd

        def one():
            return RWKVState(
                s=torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                              device=device),
                tm_x=torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
                cm_x=torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device))
    return DecodeState(caches=[one() for _ in range(cfg.num_layers)])


def _dense_layer_decode(layer_p, cfg: ArchConfig, x, cache: KVCache):
    h = rmsnorm(layer_p["ln1"], x)
    a, cache = attn_decode(layer_p["attn"], cfg, h, cache,
                           window=cfg.swa_window)
    x = x + a
    h = rmsnorm(layer_p["ln2"], x)
    return x + mlp_forward(layer_p["mlp"], h, cfg.mlp), cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                state: DecodeState) -> tuple[torch.Tensor, DecodeState]:
    """token: (B,) int — returns (logits (B, V_padded), new state)."""
    _require_ported(cfg)
    x = _embed(params, token[:, None])                      # (B, 1, D)
    caches = []
    for layer, st in zip(params["layers"], state.caches):
        if cfg.family == "dense":
            x, st = _dense_layer_decode(layer, cfg, x, st)
        else:
            x, st = rwkv_block_decode(layer["blk"], cfg, x,
                                      (layer["ln1"], layer["ln2"]), st)
        caches.append(st)
    x = rmsnorm(params["norm_f"], x)
    return (x @ _head_matrix(params))[:, 0], state._replace(caches=caches)


# ===========================================================================
# prefill (forward + state for serving)
# ===========================================================================

def _prefill_kv(attn_p, cfg: ArchConfig, h, positions,
                cache: KVCache) -> KVCache:
    """The prompt's RoPE'd keys and values written into ``cache``. When the
    prompt fills the cache (a window shorter than the prompt), the last
    ``length`` positions are kept in the ring layout: position p at slot
    p % length."""
    b, s, _ = h.shape
    K, dh = cfg.num_kv_heads, cfg.hdim
    k = linear(attn_p["wk"], h).reshape(b, s, K, dh)
    v = linear(attn_p["wv"], h).reshape(b, s, K, dh)
    k = apply_rope(k, positions, cfg.rope_theta)
    length = cache.k.shape[1]
    if s >= length:
        return KVCache(k=torch.roll(k[:, -length:], s % length, 1),
                       v=torch.roll(v[:, -length:], s % length, 1), pos=s)
    k_new, v_new = cache.k.clone(), cache.v.clone()
    k_new[:, :s] = k
    v_new[:, :s] = v
    return KVCache(k=k_new, v=v_new, pos=s)


def prefill(params, cfg: ArchConfig, batch: dict, max_seq: int
            ) -> tuple[torch.Tensor, DecodeState]:
    """Run the prompt through the model, returning last-token logits
    (B, V_padded) and the decode-ready state after the last token. Dense
    layers recompute the prompt's K/V beside the layer's forward, as the
    reference does; where the reference runs the whole forward a second
    time for the caches, the port fills them in the same pass, which
    computes the same values. RWKV6 threads its state through the
    sequence pass."""
    _require_ported(cfg)
    x = _embed(params, batch["tokens"])
    states = []
    if cfg.family == "dense":
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)
        for layer in params["layers"]:
            cache = init_kv_cache(B, max_seq, cfg.num_kv_heads, cfg.hdim,
                                  cfg.activation_dtype,
                                  window=cfg.swa_window, device=x.device)
            h = rmsnorm(layer["ln1"], x)
            states.append(_prefill_kv(layer["attn"], cfg, h, positions,
                                      cache))
            x, _ = _dense_layer_fwd(layer, cfg, x, positions)
    else:
        for layer in params["layers"]:
            x, st = rwkv_block(layer["blk"], cfg, x,
                               (layer["ln1"], layer["ln2"]),
                               return_state=True)
            states.append(st)
    x = rmsnorm(params["norm_f"], x)
    return x[:, -1] @ _head_matrix(params), DecodeState(caches=states)
