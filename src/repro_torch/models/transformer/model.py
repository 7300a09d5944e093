"""Model assembly for the transformer side workload, every family.

The port of the reference's ``models/transformer/model.py``: dense GQA
(with sliding window and KV cache), MoE (the dense layer with a routed
expert layer in place of the MLP), RWKV6 (``ssm``), the RG-LRU hybrid
(recurrent and local-attention positions in a repeating pattern), the VLM
(a dense decoder behind a projected patch prefix) and whisper-style audio
(an encoder-decoder):

  * ``init_params(cfg, generator, device)`` — seeded random parameters
  * ``forward(params, cfg, batch)``         — full logits (+ aux)
  * ``loss_fn(params, cfg, batch)``         — next-token CE (+ MoE aux)
  * ``prefill(params, cfg, batch, max_seq)`` — last-token logits + state
  * ``init_decode_state(cfg, batch, max_seq, device)`` — empty caches
  * ``decode_step(params, cfg, token, state)`` — one-token serve step
  * ``params_from_jax(tree, cfg, device)`` — the reference's tree, converted

Parameters are plain dicts of tensors in the reference's tree layout,
except that what the reference stacks on a leading axis for ``lax.scan``
is a list here: ``layers`` (dense, moe, vlm, ssm), ``enc_layers`` and
``dec_layers`` (audio) are lists of per-layer dicts, and the hybrid's
``groups`` is a list of ``{"blocks": [position, ...]}``, one per pattern
period, beside its ``tail`` list of the positions left over. Layers (a
hybrid's whole period) run as a Python loop, each under
``torch.utils.checkpoint`` when autograd records (the reference's
``jax.checkpoint`` of the scanned body: full remat). The decode state's
``caches`` mirror them: a ``KVCache`` per dense, moe or vlm layer, an
``RWKVState`` per RWKV6 layer, ``{"blocks": [...]}`` of ``RGLRUState`` and
``KVCache`` per hybrid period (and ``tail``), a ``DecLayerCache`` per
audio decoder layer (and ``enc``).

The reference's dry-run knobs: ``set_sequence_sharding`` (the carry's
sequence over the TP axis at layer boundaries, ``_carry_shard``) and
``set_remat_policy`` (``"full"``, or ``"dots"``: matmul outputs saved by a
selective checkpoint) act here too, and ``scan_length`` is the reference's
count of layer iterations, kept for the dry run's record. The ``shard``
hints stand where the reference has them and act only on DTensors
(``common.shard``). ``set_scan_unroll`` has no counterpart: the layers are
a Python loop, so every layer's FLOPs are counted as it runs.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models.transformer import encdec
from repro_torch.models.transformer.attention import (
    KVCache, attn_decode, attn_forward, init_attn, init_kv_cache)
from repro_torch.models.transformer.common import (
    _dtensor, apply_rope, from_local_shards, gather_fsdp, gather_sequence,
    init_linear, init_rmsnorm, layernorm, linear, rmsnorm, shard,
    split_heads, to_local_shards)
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.mlp import init_mlp, mlp_forward
from repro_torch.models.transformer.moe import init_moe, moe_forward
from repro_torch.models.transformer.rglru import (
    init_rglru_block, init_rglru_state, rglru_block, rglru_block_decode)
from repro_torch.models.transformer.rwkv6 import (
    RWKVState, init_rwkv_block, rwkv_block, rwkv_block_decode)

# leaves the reference keeps in float32 whatever the model's dtype, by name
# (RWKV6's decay bias and bonus, RG-LRU's Λ) and by path (the MoE router,
# whose leaf is named ``w`` like every linear's)
_F32_LEAVES = ("w_base", "u", "lam")
_F32_PATHS = (("moe", "router", "w"),)
# the reference's leaves stacked on a leading axis for its scans
_STACKED = ("layers", "enc_layers", "dec_layers", "groups")


class DecodeState(NamedTuple):
    caches: Any             # list of per-layer (hybrid: per-period) caches
    tail: Any = None        # hybrid: the tail positions' caches
    enc: Any = None         # audio: the encoder's output


# Sequence parallelism (Korthikanti et al.): shard the residual stream's
# *sequence* dim over the model axis at layer boundaries. The saved carries
# of the checkpointed layers then shard over tp, and the gather before
# attention is the sequence-parallel collective. A no-op on plain tensors.
_SEQ_SHARD = [True]


def set_sequence_sharding(on: bool) -> None:
    _SEQ_SHARD[0] = bool(on)


def _carry_shard(x):
    if _SEQ_SHARD[0]:
        return shard(x, "dp", "tp", None)
    return shard(x, "dp", None, None)


# Remat policy of the per-layer checkpoint. "full" recomputes everything
# (min memory, but collectives inside the layer fire twice — forward and
# recompute); "dots" saves matmul outputs, so the backward pass reuses them
# and cross-shard partial-sum reductions run once.
_REMAT_POLICY = ["full"]
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def set_remat_policy(name: str) -> None:
    if name not in ("full", "dots"):
        raise ValueError(f"remat policy {name!r}; have 'full' and 'dots'")
    _REMAT_POLICY[0] = name


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _ckpt(fn, *args):
    """``fn(*args)``, recomputed in the backward pass instead of saved when
    autograd records (non-reentrant ``torch.utils.checkpoint``); under the
    "dots" policy the outputs of mm, bmm and addmm are saved."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if _REMAT_POLICY[0] == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    return checkpoint(fn, *args, use_reentrant=False)


def scan_length(cfg: ArchConfig) -> int:
    """The reference's layer-scan trip count: pattern periods for a
    hybrid, layers otherwise (audio's encoder and decoder have as many)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // len(tuple(cfg.block_pattern))
    if cfg.family == "audio":
        assert cfg.encoder_layers == cfg.num_layers
        return cfg.num_layers
    return cfg.num_layers


def _pattern(cfg: ArchConfig) -> tuple[tuple, int, int]:
    """A hybrid's block pattern, its number of full periods, and the
    number of positions left over (the tail)."""
    pat = tuple(cfg.block_pattern)
    n_groups = cfg.num_layers // len(pat)
    return pat, n_groups, cfg.num_layers - n_groups * len(pat)


# ===========================================================================
# init
# ===========================================================================

def _init_dense_layer(g, cfg: ArchConfig, dtype, device) -> dict:
    p = {"ln1": init_rmsnorm(cfg.d_model, dtype, device),
         "attn": init_attn(g, cfg, dtype, device=device),
         "ln2": init_rmsnorm(cfg.d_model, dtype, device)}
    if cfg.moe_num_experts:
        p["moe"] = init_moe(g, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(g, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device)
    return p


def _init_rwkv_layer(g, cfg: ArchConfig, dtype, device) -> dict:
    return {"ln1": init_rmsnorm(cfg.d_model, dtype, device),
            "ln2": init_rmsnorm(cfg.d_model, dtype, device),
            "blk": init_rwkv_block(g, cfg, dtype, device)}


def _init_hybrid_position(g, cfg: ArchConfig, dtype, device,
                          kind: str) -> dict:
    p = {"ln1": init_rmsnorm(cfg.d_model, dtype, device)}
    if kind == "rec":
        p["blk"] = init_rglru_block(g, cfg, dtype, device)
    else:
        p["attn"] = init_attn(g, cfg, dtype, device=device)
    p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device)
    p["mlp"] = init_mlp(g, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device)
    return p


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random parameters drawn on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``) from ``generator``, which must
    live on that device (default: seed 0; on ``meta``, which draws
    nothing, shapes and dtypes alone, no generator). The draws differ from the
    reference's ``jax.random`` ones; to hold the two packages against each
    other, convert the reference's tree with :func:`params_from_jax`."""
    device = resolve_device(device)
    g = generator
    if g is None and device.type != "meta":
        g = torch.Generator(device=device).manual_seed(0)
    dtype = cfg.activation_dtype
    D, V = cfg.d_model, cfg.padded_vocab

    def normal(shape):
        return (torch.randn(shape, generator=g, device=device) * 0.02
                ).to(dtype)

    p: dict[str, Any] = {"embed": normal((V, D)),
                         "norm_f": init_rmsnorm(D, dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = normal((D, V))
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        p["layers"] = [_init_dense_layer(g, cfg, dtype, device)
                       for _ in range(cfg.num_layers)]
        if fam == "vlm":
            p["patch_proj"] = init_linear(g, cfg.patch_dim, D, dtype,
                                          device=device)
    elif fam == "ssm":
        p["layers"] = [_init_rwkv_layer(g, cfg, dtype, device)
                       for _ in range(cfg.num_layers)]
    elif fam == "hybrid":
        pat, n_groups, rem = _pattern(cfg)
        p["groups"] = [{"blocks": [_init_hybrid_position(g, cfg, dtype,
                                                         device, kind)
                                   for kind in pat]}
                       for _ in range(n_groups)]
        p["tail"] = [_init_hybrid_position(g, cfg, dtype, device,
                                           pat[j % len(pat)])
                     for j in range(rem)]
    elif fam == "audio":
        De = cfg.encoder_d_model or D
        p["enc_pos"] = normal((cfg.encoder_seq, De))
        p["enc_layers"] = [encdec.init_encoder_layer(g, De, De * 4, dtype,
                                                     device)
                           for _ in range(cfg.encoder_layers)]
        p["enc_ln_f"] = init_rmsnorm(De, dtype, device)
        p["dec_layers"] = [encdec.init_decoder_layer(g, D, cfg.d_ff, dtype,
                                                     device)
                           for _ in range(cfg.num_layers)]
    else:
        raise ValueError(fam)
    return p


def params_from_jax(tree: dict, cfg: ArchConfig, device) -> dict:
    """The reference's ``init_params`` tree (numpy or JAX arrays, scanned
    leaves stacked on a leading axis) as the port's parameters on
    ``device``: RWKV6's ``w_base`` and ``u``, RG-LRU's ``lam`` and the MoE
    router in float32, every other leaf in ``cfg``'s dtype; the stacked
    subtrees (``layers``, ``enc_layers``, ``dec_layers``, the hybrid's
    ``groups``) as lists, the hybrid's ``tail`` as it is. Leaves pass
    through float32, which holds bfloat16 exactly, so values copy
    exactly."""
    device = torch.device(device)
    dtype = cfg.activation_dtype

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        f32 = path[-1] in _F32_LEAVES or path[-3:] in _F32_PATHS
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        return t.to(device, torch.float32 if f32 else dtype)

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        if isinstance(node, list):
            return [pick(v, i) for v in node]
        return node[i]

    def first_leaf(node):
        while isinstance(node, (dict, list)):
            node = next(iter(node.values())) if isinstance(node, dict) \
                else node[0]
        return node

    want = {"layers": cfg.num_layers, "dec_layers": cfg.num_layers,
            "enc_layers": cfg.encoder_layers}
    if cfg.family == "hybrid":
        want["groups"] = _pattern(cfg)[1]
    out = walk(tree)
    for key in _STACKED:
        if key not in out:
            continue
        n = first_leaf(out[key]).shape[0]
        if n != want[key]:
            raise ValueError(f"tree has {n} {key}, cfg {want[key]}")
        out[key] = [pick(out[key], i) for i in range(n)]
    return out


# ===========================================================================
# layer bodies and forward (train / prefill logits)
# ===========================================================================

def _dense_layer_fwd(layer_p, cfg: ArchConfig, x, positions,
                     moe_stats: Optional[list] = None):
    """One dense, moe or vlm layer: (x, the layer's aux loss). A MoE
    layer's stats are appended to ``moe_stats`` when it is a list."""
    h = rmsnorm(layer_p["ln1"], x)
    x = x + attn_forward(layer_p["attn"], cfg, h, positions,
                         window=cfg.swa_window)
    x = shard(x, "dp", None, None)
    h = rmsnorm(layer_p["ln2"], x)
    if cfg.moe_num_experts:
        y, stats = moe_forward(layer_p["moe"], cfg, h)
        if moe_stats is not None:
            moe_stats.append(stats)
        return x + y, stats.aux_loss
    return (x + mlp_forward(layer_p["mlp"], h, cfg.mlp),
            torch.zeros((), device=x.device))


def _hybrid_position_fwd(pos_p, cfg: ArchConfig, x, positions, kind: str):
    if kind == "rec":
        x = rglru_block(pos_p["blk"], cfg, x, pos_p["ln1"])
    else:
        h = rmsnorm(pos_p["ln1"], x)
        x = x + attn_forward(pos_p["attn"], cfg, h, positions,
                             window=cfg.local_attn_window)
    h = rmsnorm(pos_p["ln2"], x)
    return x + mlp_forward(pos_p["mlp"], h, cfg.mlp)


def _hybrid_group_fwd(grp, cfg: ArchConfig, x, positions):
    for pos_p, kind in zip(grp["blocks"], cfg.block_pattern):
        x = _hybrid_position_fwd(pos_p, cfg, x, positions, kind)
    return x


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    if _dtensor(emb):
        # without autograd, the vocab-parallel lookup (masked partial rows,
        # reduced at once). Under autograd (DTensor has no backward for the
        # masked partial sum) the table gathered over TP as well and each
        # rank's rows looked up in it as plain tensors, the lookup the
        # one-card path runs; its gradient is a partial sum over dp.
        emb = gather_fsdp(emb)
        if not torch.is_grad_enabled():
            return shard(F.embedding(tokens.to(torch.long), emb),
                         "dp", None, None)
        rows = to_local_shards(emb, None, None, shared=True)[
            to_local_shards(tokens, "dp", None).to(torch.long)]
        return from_local_shards(rows, emb.device_mesh,
                                 (*tokens.shape, emb.shape[1]),
                                 "dp", None, None)
    return emb[tokens.to(emb.device, torch.long)]


def _with_patches(params, batch: dict, x: torch.Tensor) -> torch.Tensor:
    """The vlm input: the projected patches (B, P, D) before the token
    embeddings. The projection is float32, as the reference's float32
    patches promote its product, then cast to the activations' dtype."""
    w = params["patch_proj"]
    pe = linear({k: v.float() for k, v in w.items()},
                batch["patches"].to(x.device, torch.float32))
    return torch.cat([pe.to(x.dtype), x], 1)


def _encode(params, cfg: ArchConfig, frames: torch.Tensor, dtype
            ) -> torch.Tensor:
    """The audio encoder over the stub's frame embeddings (B, S_enc, De):
    learned positions, the layers, and a final RMSNorm (the reference's,
    though the layers use LayerNorm)."""
    e = frames.to(params["enc_pos"].device, dtype) + params["enc_pos"]
    for layer in params["enc_layers"]:
        e = _carry_shard(_ckpt(encdec.encoder_layer, layer, e,
                               cfg.num_heads))
    return rmsnorm(params["enc_ln_f"], e)


def _head_matrix(params):
    head = params.get("head")
    return gather_fsdp(head) if head is not None \
        else gather_fsdp(params["embed"]).T


def forward_hidden(params, cfg: ArchConfig, batch: dict,
                   moe_stats: Optional[list] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Backbone only: returns (final-normed hidden (B, S, D), aux_loss).

    batch keys by family:
      dense/moe/ssm/hybrid: tokens (B, S)
      vlm:   tokens (B, S_text), patches (B, P, patch_dim); S = P + S_text
      audio: tokens (B, S_dec), frames (B, S_enc, De)

    With a list ``moe_stats``, each MoE layer's ``MoEStats`` (its routing
    included) is appended to it, and the layers run without
    checkpointing."""
    fam = cfg.family
    x = _embed(params, batch["tokens"])
    if fam == "vlm":
        x = _with_patches(params, batch, x)
    x = shard(x, "dp", None, None)
    aux = torch.zeros((), device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    if fam in ("dense", "moe", "vlm"):
        for layer in params["layers"]:
            if moe_stats is None:
                x, a = _ckpt(_dense_layer_fwd, layer, cfg, x, positions)
            else:
                x, a = _dense_layer_fwd(layer, cfg, x, positions, moe_stats)
            x = _carry_shard(x)
            aux = aux + a
    elif fam == "ssm":
        for layer in params["layers"]:
            x = _carry_shard(_ckpt(rwkv_block, layer["blk"], cfg, x,
                                   (layer["ln1"], layer["ln2"])))
    elif fam == "hybrid":
        pat = tuple(cfg.block_pattern)
        for grp in params["groups"]:
            x = _carry_shard(_ckpt(_hybrid_group_fwd, grp, cfg, x,
                                   positions))
        for j, pos_p in enumerate(params["tail"]):
            x = _hybrid_position_fwd(pos_p, cfg, x, positions,
                                     pat[j % len(pat)])
    elif fam == "audio":
        enc = _encode(params, cfg, batch["frames"], x.dtype)
        for layer in params["dec_layers"]:
            x = _carry_shard(_ckpt(encdec.decoder_layer, layer, x, enc,
                                   cfg.num_heads))
    else:
        raise ValueError(fam)
    return rmsnorm(params["norm_f"], x), aux


def forward(params, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full logits (B, S, V_padded) and the aux loss (MoE's balance loss
    summed over the layers; 0 for the other families) — the serving/debug
    path. Training goes through :func:`loss_fn` (chunked CE; full-sequence
    float32 logits never exist)."""
    x, aux = forward_hidden(params, cfg, batch)
    return shard(x @ _head_matrix(params), "dp", None, "tp"), aux


# ===========================================================================
# training loss
# ===========================================================================

def _labels_and_mask(cfg: ArchConfig, batch: dict, S: int, device):
    """Next-token labels aligned to hidden positions, with a validity mask
    (the last position has no next token). For vlm, position p ≥ P-1
    predicts text token p-(P-1); the patch prefix itself is
    unsupervised."""
    tokens = batch["tokens"].to(device)
    B = tokens.shape[0]
    last = (torch.arange(S, device=device) < S - 1)[None]
    if cfg.family == "vlm":
        P = batch["patches"].shape[1]
        s_text = tokens.shape[1]
        idx = torch.arange(S, device=device) - (P - 1)
        valid = (idx >= 0) & (idx < s_text)
        labels = tokens[:, torch.clamp(idx, 0, s_text - 1)]
        return labels, (valid[None] & last).expand(B, S)
    labels = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], 1)
    return labels, last.expand(B, S)


def _ce_chunk(W, xc, lc, mc):
    logits = (xc @ W).float()                       # (B, C, V)
    logz = torch.logsumexp(logits, -1)
    if _dtensor(logits):
        # over a vocab shard, the gold logit as a vocab-parallel sum with
        # one nonzero term (DTensor's masked gather fails to reduce); the
        # same value as the gather
        hot = F.one_hot(lc.long(), logits.shape[-1]).to(logits.dtype)
        gold = (logits * hot).sum(-1)
    else:
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
    m = mc.float()
    return ((logz - gold) * m).sum(), m.sum()


def chunked_ce(params, x: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over sequence chunks of ``chunk`` positions, each
    recomputed in the backward pass: the (B, S, V) float32 logits never
    exist — only one chunk's (B, C, V) at a time. S is padded to a
    multiple of C (padding masked), and the chunks' sums accumulate in
    order, as the reference's scan carries them. A DTensor x has its
    sequence gathered first (``gather_sequence``)."""
    W = _head_matrix(params)
    x = gather_sequence(x)
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
    times the aux loss (MoE's balance loss summed over the layers; zero
    for the other families)."""
    x, aux = forward_hidden(params, cfg, batch)
    labels, mask = _labels_and_mask(cfg, batch, x.shape[1], x.device)
    ce = chunked_ce(params, x, labels, mask)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ===========================================================================
# decode
# ===========================================================================

def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      device=None, enc: Optional[torch.Tensor] = None,
                      params=None) -> DecodeState:
    """Empty per-layer caches: a KV cache of ``min(max_seq, window)``
    slots per attention layer or position (the sliding window, or the
    hybrid's local window); a zero state per RWKV6 layer and per RG-LRU
    position, whose state does not grow with the sequence. Audio needs
    the encoder's output ``enc`` and ``params``, from which each decoder
    layer's cross-attention keys and values are computed (on ``enc``'s
    device)."""
    dtype = cfg.activation_dtype
    fam = cfg.family
    if fam == "audio":
        if enc is None or params is None:
            raise ValueError("an audio decode state needs the encoder "
                             "output (enc) and the params")
        caches = [encdec.init_decoder_cache(layer, enc, batch, max_seq,
                                            cfg.num_heads, cfg.d_model, dtype)
                  for layer in params["dec_layers"]]
        return DecodeState(caches=caches, enc=enc)
    device = resolve_device(device)

    def kv(window):
        return init_kv_cache(batch, max_seq, cfg.num_kv_heads, cfg.hdim,
                             dtype, window=window, device=device)

    if fam in ("dense", "moe", "vlm"):
        return DecodeState(caches=[kv(cfg.swa_window)
                                   for _ in range(cfg.num_layers)])
    if fam == "ssm":
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
    if fam == "hybrid":
        pat, n_groups, rem = _pattern(cfg)

        def pos_cache(kind):
            if kind == "rec":
                return init_rglru_state(batch, cfg, device)
            return kv(cfg.local_attn_window)
        return DecodeState(
            caches=[{"blocks": [pos_cache(kind) for kind in pat]}
                    for _ in range(n_groups)],
            tail=[pos_cache(pat[j % len(pat)]) for j in range(rem)])
    raise ValueError(fam)


def _dense_layer_decode(layer_p, cfg: ArchConfig, x, cache: KVCache):
    h = rmsnorm(layer_p["ln1"], x)
    a, cache = attn_decode(layer_p["attn"], cfg, h, cache,
                           window=cfg.swa_window)
    x = x + a
    h = rmsnorm(layer_p["ln2"], x)
    if cfg.moe_num_experts:
        y, _ = moe_forward(layer_p["moe"], cfg, h)
        return x + y, cache
    return x + mlp_forward(layer_p["mlp"], h, cfg.mlp), cache


def _hybrid_position_decode(pos_p, cfg: ArchConfig, x, pos_c, kind: str):
    if kind == "rec":
        x, pos_c = rglru_block_decode(pos_p["blk"], cfg, x, pos_p["ln1"],
                                      pos_c)
    else:
        h = rmsnorm(pos_p["ln1"], x)
        a, pos_c = attn_decode(pos_p["attn"], cfg, h, pos_c,
                               window=cfg.local_attn_window)
        x = x + a
    h = rmsnorm(pos_p["ln2"], x)
    return x + mlp_forward(pos_p["mlp"], h, cfg.mlp), pos_c


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                state: DecodeState) -> tuple[torch.Tensor, DecodeState]:
    """token: (B,) int — returns (logits (B, V_padded), new state)."""
    fam = cfg.family
    x = _embed(params, token[:, None])                      # (B, 1, D)
    if fam in ("dense", "moe", "vlm", "ssm"):
        caches = []
        for layer, st in zip(params["layers"], state.caches):
            if fam == "ssm":
                x, st = rwkv_block_decode(layer["blk"], cfg, x,
                                          (layer["ln1"], layer["ln2"]), st)
            else:
                x, st = _dense_layer_decode(layer, cfg, x, st)
            caches.append(st)
        state = state._replace(caches=caches)
    elif fam == "hybrid":
        pat = tuple(cfg.block_pattern)
        caches = []
        for grp_p, grp_c in zip(params["groups"], state.caches):
            blocks = []
            for pos_p, pos_c, kind in zip(grp_p["blocks"], grp_c["blocks"],
                                          pat):
                x, pos_c = _hybrid_position_decode(pos_p, cfg, x, pos_c,
                                                   kind)
                blocks.append(pos_c)
            caches.append({"blocks": blocks})
        tail = []
        for j, (pos_p, pos_c) in enumerate(zip(params["tail"], state.tail)):
            x, pos_c = _hybrid_position_decode(pos_p, cfg, x, pos_c,
                                               pat[j % len(pat)])
            tail.append(pos_c)
        state = state._replace(caches=caches, tail=tail)
    elif fam == "audio":
        caches = []
        for layer, c in zip(params["dec_layers"], state.caches):
            x, c = encdec.decoder_layer_decode(layer, x, c, cfg.num_heads)
            caches.append(c)
        state = state._replace(caches=caches)
    else:
        raise ValueError(fam)
    x = rmsnorm(params["norm_f"], x)
    return (x @ _head_matrix(params))[:, 0], state


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
    k = split_heads(linear(attn_p["wk"], h), K, dh)
    v = split_heads(linear(attn_p["wv"], h), K, dh)
    k = apply_rope(k, positions, cfg.rope_theta)
    length = cache.k.shape[1]
    if s >= length:
        return KVCache(k=torch.roll(k[:, -length:], s % length, 1),
                       v=torch.roll(v[:, -length:], s % length, 1), pos=s)
    k_new, v_new = cache.k.clone(), cache.v.clone()
    k_new[:, :s] = k
    v_new[:, :s] = v
    return KVCache(k=k_new, v=v_new, pos=s)


def _prefill_hybrid_position(pos_p, cfg: ArchConfig, x, positions,
                             max_seq: int, kind: str):
    """One hybrid position over the prompt: (x, its decode state)."""
    if kind == "rec":
        x2, st = rglru_block(pos_p["blk"], cfg, x, pos_p["ln1"],
                             return_state=True)
    else:
        h = rmsnorm(pos_p["ln1"], x)
        cache = init_kv_cache(x.shape[0], max_seq, cfg.num_kv_heads,
                              cfg.hdim, cfg.activation_dtype,
                              window=cfg.local_attn_window, device=x.device)
        st = _prefill_kv(pos_p["attn"], cfg, h, positions, cache)
        x2 = x + attn_forward(pos_p["attn"], cfg, h, positions,
                              window=cfg.local_attn_window)
    h = rmsnorm(pos_p["ln2"], x2)
    return x2 + mlp_forward(pos_p["mlp"], h, cfg.mlp), st


def _prefill_audio(params, cfg: ArchConfig, batch: dict, max_seq: int
                   ) -> tuple[torch.Tensor, DecodeState]:
    """The encoder once; then the decoder over the prompt, filling each
    layer's self-attention cache with the prompt's keys and values."""
    x = _embed(params, batch["tokens"])
    B, s_len, _ = x.shape
    enc = _encode(params, cfg, batch["frames"], x.dtype)
    state = init_decode_state(cfg, B, max_seq, enc=enc, params=params)
    dh = cfg.d_model // cfg.num_heads
    caches = []
    for layer, cache in zip(params["dec_layers"], state.caches):
        h = layernorm(layer["ln1"], x)
        kv = cache.self_kv
        length = kv.k.shape[1]
        k_new, v_new = kv.k.clone(), kv.v.clone()
        n = min(s_len, length)
        k_new[:, :n] = linear(layer["self_attn"]["wk"], h).reshape(
            B, s_len, cfg.num_heads, dh)[:, :n]
        v_new[:, :n] = linear(layer["self_attn"]["wv"], h).reshape(
            B, s_len, cfg.num_heads, dh)[:, :n]
        caches.append(cache._replace(self_kv=KVCache(k=k_new, v=v_new,
                                                     pos=s_len)))
        x = encdec.decoder_layer(layer, x, enc, cfg.num_heads)
    x = rmsnorm(params["norm_f"], x)
    return x[:, -1] @ _head_matrix(params), state._replace(caches=caches)


def prefill(params, cfg: ArchConfig, batch: dict, max_seq: int
            ) -> tuple[torch.Tensor, DecodeState]:
    """Run the prompt through the model, returning last-token logits
    (B, V_padded) and the decode-ready state after the last token. Dense,
    moe and vlm layers recompute the prompt's K/V beside the layer's
    forward, as the reference does; where the reference runs the whole
    forward a second time for the caches, the port fills them in the same
    pass, which computes the same values. RWKV6 and the hybrid thread
    their recurrent and window states through the sequence pass; audio
    encodes once and fills the decoder's self-attention caches."""
    fam = cfg.family
    if fam == "audio":
        return _prefill_audio(params, cfg, batch, max_seq)
    x = _embed(params, batch["tokens"])
    if fam == "vlm":
        x = _with_patches(params, batch, x)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    states, tail = [], None
    if fam in ("dense", "moe", "vlm"):
        for layer in params["layers"]:
            cache = init_kv_cache(B, max_seq, cfg.num_kv_heads, cfg.hdim,
                                  cfg.activation_dtype,
                                  window=cfg.swa_window, device=x.device)
            h = rmsnorm(layer["ln1"], x)
            states.append(_prefill_kv(layer["attn"], cfg, h, positions,
                                      cache))
            x, _ = _dense_layer_fwd(layer, cfg, x, positions)
    elif fam == "ssm":
        for layer in params["layers"]:
            x, st = rwkv_block(layer["blk"], cfg, x,
                               (layer["ln1"], layer["ln2"]),
                               return_state=True)
            states.append(st)
    elif fam == "hybrid":
        pat = tuple(cfg.block_pattern)
        for grp in params["groups"]:
            blocks = []
            for pos_p, kind in zip(grp["blocks"], pat):
                x, st = _prefill_hybrid_position(pos_p, cfg, x, positions,
                                                 max_seq, kind)
                blocks.append(st)
            states.append({"blocks": blocks})
        tail = []
        for j, pos_p in enumerate(params["tail"]):
            x, st = _prefill_hybrid_position(pos_p, cfg, x, positions,
                                             max_seq, pat[j % len(pat)])
            tail.append(st)
    else:
        raise ValueError(fam)
    x = rmsnorm(params["norm_f"], x)
    return x[:, -1] @ _head_matrix(params), DecodeState(caches=states,
                                                         tail=tail)
