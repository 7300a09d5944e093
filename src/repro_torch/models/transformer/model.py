"""Model assembly for the transformer side workload — the ``ssm`` family.

The port of the reference's ``models/transformer/model.py`` for RWKV6:

  * ``init_params(cfg, generator, device)`` — seeded random parameters
  * ``forward(params, cfg, batch)``         — full logits (+ aux)
  * ``prefill(params, cfg, batch, max_seq)`` — last-token logits + state
  * ``init_decode_state(cfg, batch, max_seq, device)`` — zero state
  * ``decode_step(params, cfg, token, state)`` — one-token serve step
  * ``params_from_jax(tree, cfg, device)`` — the reference's tree, converted

Parameters are plain dicts of tensors in the reference's tree layout, except
that ``layers`` is a list of per-layer dicts (the reference stacks them on a
leading axis for ``lax.scan``); layers run as a Python loop. The decode
state's ``caches`` is likewise a list of per-layer ``RWKVState``s. The other
families (dense, moe, hybrid, audio, vlm) raise ``NotImplementedError`` until
they are ported (ROADMAP.md, Queue 1 item 9); the training pieces
(``loss_fn``, ``chunked_ce``) arrive with the training slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer.common import init_rmsnorm, rmsnorm
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.rwkv6 import (
    RWKVState, init_rwkv_block, rwkv_block, rwkv_block_decode)

# leaves the reference keeps in float32 whatever the model's dtype
_F32_LEAVES = ("w_base", "u")


def _require_ssm(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 9); the port runs 'ssm'")


class DecodeState(NamedTuple):
    caches: Any             # list of per-layer RWKVState


# ===========================================================================
# init
# ===========================================================================

def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random parameters drawn on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``) from ``generator``, which must
    live on that device (default: seed 0). The draws differ from the
    reference's ``jax.random`` ones; to hold the two packages against each
    other, convert the reference's tree with :func:`params_from_jax`."""
    _require_ssm(cfg)
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
    p["layers"] = [{"ln1": init_rmsnorm(D, dtype, device),
                    "ln2": init_rmsnorm(D, dtype, device),
                    "blk": init_rwkv_block(g, cfg, dtype, device)}
                   for _ in range(cfg.num_layers)]
    return p


def params_from_jax(tree: dict, cfg: ArchConfig, device) -> dict:
    """The reference's ``init_params`` tree (numpy or JAX arrays, layer
    leaves stacked on a leading ``L`` axis) as the port's parameters on
    ``device``: ``w_base`` and ``u`` in float32, every other leaf in
    ``cfg``'s dtype. Leaves pass through float32, which holds bfloat16
    exactly, so values copy exactly."""
    _require_ssm(cfg)
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
# forward (prefill logits)
# ===========================================================================

def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    return emb[tokens.to(emb.device, torch.long)]


def _head_matrix(params):
    head = params.get("head")
    return head if head is not None else params["embed"].T


def forward_hidden(params, cfg: ArchConfig, batch: dict
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Backbone only: returns (final-normed hidden (B, S, D), aux_loss)."""
    _require_ssm(cfg)
    x = _embed(params, batch["tokens"])
    for layer in params["layers"]:
        x = rwkv_block(layer["blk"], cfg, x, (layer["ln1"], layer["ln2"]))
    return rmsnorm(params["norm_f"], x), torch.zeros((), device=x.device)


def forward(params, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full logits (B, S, V_padded) and the aux loss (0 for RWKV6)."""
    x, aux = forward_hidden(params, cfg, batch)
    return x @ _head_matrix(params), aux


# ===========================================================================
# decode
# ===========================================================================

def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      device=None) -> DecodeState:
    """Zero per-layer state; ``max_seq`` is unused by RWKV6, whose state
    does not grow with the sequence."""
    _require_ssm(cfg)
    device = resolve_device(device)
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    dtype = cfg.activation_dtype

    def one():
        return RWKVState(
            s=torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                          device=device),
            tm_x=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            cm_x=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))
    return DecodeState(caches=[one() for _ in range(cfg.num_layers)])


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                state: DecodeState) -> tuple[torch.Tensor, DecodeState]:
    """token: (B,) int — returns (logits (B, V_padded), new state)."""
    _require_ssm(cfg)
    x = _embed(params, token[:, None])                      # (B, 1, D)
    caches = []
    for layer, st in zip(params["layers"], state.caches):
        x, st = rwkv_block_decode(layer["blk"], cfg, x,
                                  (layer["ln1"], layer["ln2"]), st)
        caches.append(st)
    x = rmsnorm(params["norm_f"], x)
    return (x @ _head_matrix(params))[:, 0], state._replace(caches=caches)


# ===========================================================================
# prefill (forward + state for serving)
# ===========================================================================

def prefill(params, cfg: ArchConfig, batch: dict, max_seq: int
            ) -> tuple[torch.Tensor, DecodeState]:
    """Run the prompt through the model, returning last-token logits
    (B, V_padded) and the decode-ready state after the last token."""
    _require_ssm(cfg)
    x = _embed(params, batch["tokens"])
    states = []
    for layer in params["layers"]:
        x, st = rwkv_block(layer["blk"], cfg, x, (layer["ln1"], layer["ln2"]),
                           return_state=True)
        states.append(st)
    x = rmsnorm(params["norm_f"], x)
    return x[:, -1] @ _head_matrix(params), DecodeState(caches=states)
