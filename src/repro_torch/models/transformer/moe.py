"""Mixture-of-experts layer (qwen2-moe, deepseek-moe) with HopMoE's α choice.

The port of the reference's ``models/transformer/moe.py``. Routing is
GShard-style capacity-based dispatch computed *per batch row*: each token's
top-k experts take the next free slot of their (expert, capacity) buffer
in the row's flat (token, choice) order, and a token past an expert's
capacity is dropped to a spill row that is cut off. Expert compute is one
stacked einsum over (B, E, C, D) buffers, so the work is proportional to
capacity, not to E.

HopMoE's ``auto`` mode compares, per layer, the bytes the ``tokens``
sharding would move (the dispatch buffers, out and back) with those of the
``weights`` sharding (an all-reduce of the output's float32 partial sums)
and names the cheaper one. Both modes compute the same output: they differ
only in the reference's sharding hints, which act on DTensors alone
(``common.shard``): ``tokens`` shards the dispatch buffers and the expert
stacks on the expert axis over TP, ``weights`` keeps the buffers whole and
shards the experts' ffn dim. ``MoEStats`` carries the decision and both byte counts, equal to
the reference's, and the routing itself, so a caller can compare it across
devices.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.common import (
    _dtensor, from_local_shards, gather_fsdp, init_linear, linear, shard,
    to_local_shards)
from repro_torch.models.transformer.mlp import init_mlp, mlp_forward


def moe_capacity(seq: int, top_k: int, num_experts: int,
                 capacity_factor: float, multiple: int = 8) -> int:
    """Slots per expert per row: ``seq·k/E·factor`` + 1 rounded up to a
    multiple of 8; 1 when decoding (seq 1), where an 8-slot buffer would
    be 8× oversized."""
    if seq == 1:
        return 1
    c = int(seq * top_k / num_experts * capacity_factor) + 1
    return max(multiple, -(-c // multiple) * multiple)


def init_moe(generator: torch.Generator, cfg, dtype, device=None) -> dict:
    """A float32 router (whatever ``dtype``: a bf16 router would change
    which experts are picked), E stacked SwiGLU experts of width
    ``moe_expert_d_ff``, and ``moe_num_shared`` shared experts as one
    SwiGLU MLP of ``moe_num_shared`` times that width."""
    D, E, Fe = cfg.d_model, cfg.moe_num_experts, cfg.moe_expert_d_ff

    def he(shape, fan):
        x = torch.randn(shape, generator=generator, device=device)
        return (x * (2.0 / fan) ** 0.5).to(dtype)

    p = {"router": init_linear(generator, D, E, torch.float32,
                               device=device),
         "wg": he((E, D, Fe), D), "wu": he((E, D, Fe), D),
         "wd": he((E, Fe, D), Fe)}
    if cfg.moe_num_shared:
        p["shared"] = init_mlp(generator, D, cfg.moe_num_shared * Fe,
                               "swiglu", dtype, device)
    return p


class MoERouting(NamedTuple):
    probs: torch.Tensor     # (B, S, E) float32 softmax of the router
    top_e: torch.Tensor     # (B, S, k) int64, best first
    top_p: torch.Tensor     # (B, S, k) float32, renormalised over the k
    keep: torch.Tensor      # (B, S·k) bool: the choice found a free slot
    slot: torch.Tensor      # (B, S·k) int64: e·C + position, E·C if dropped


@dataclasses.dataclass
class MoEStats:
    aux_loss: torch.Tensor
    dispatch_bytes: int
    weight_bytes: int
    mode: str
    routing: MoERouting


def _alpha_mode(cfg, batch: int, seq: int) -> tuple[str, int, int]:
    """HopMoE's α decision: the bytes that must cross the model axis in
    each mode, and the mode (``cfg.moe_dispatch``, or under ``auto`` the
    one that moves fewer)."""
    D, E = cfg.d_model, cfg.moe_num_experts
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    C = moe_capacity(seq, cfg.moe_top_k, E, cfg.moe_capacity_factor)
    # tokens mode: buffers (B,E,C,D) cross the model axis out and back (×2)
    dispatch_bytes = 2 * batch * E * C * D * itemsize
    # weights mode: partial-sum all-reduce of the output (B,S,D), f32
    weight_bytes = 2 * batch * seq * D * 4
    mode = cfg.moe_dispatch
    if mode == "auto":
        mode = "tokens" if dispatch_bytes < weight_bytes else "weights"
    return mode, dispatch_bytes, weight_bytes


def moe_route(p: dict, cfg, x: torch.Tensor) -> MoERouting:
    """The router's choices for x (B, S, D) and each choice's slot. The
    capacity position of a choice is the count of earlier choices of its
    expert in the row's flat (token, choice) order."""
    B, S, _ = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    C = moe_capacity(S, k, E, cfg.moe_capacity_factor)
    probs = torch.softmax(linear(p["router"], x.float()), -1)   # (B,S,E)
    top_p, top_e = torch.topk(probs, k, -1, sorted=True)        # (B,S,k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    eid = top_e.reshape(B, S * k)                                # (B, N)
    pos = torch.cumsum(F.one_hot(eid, E), 1) - 1                 # (B,N,E)
    my_pos = pos.gather(2, eid[..., None])[..., 0]               # (B, N)
    keep = my_pos < C
    slot = torch.where(keep, eid * C + my_pos, E * C)            # drop → spill
    return MoERouting(probs=probs, top_e=top_e, top_p=top_p, keep=keep,
                      slot=slot)


def _dispatch(x_rep, slot, E: int, C: int) -> torch.Tensor:
    """Each row's kept choices into its (E, C) slots: (B, E, C, D). Kept
    slots are distinct within a row, so the sum adds each kept token to
    zeros once; only the spill row (dropped, zeroed tokens) sees repeats,
    and it is cut off."""
    B, _, D = x_rep.shape
    rows = torch.arange(B, device=x_rep.device)[:, None] * (E * C + 1)
    flat = (rows + slot).reshape(-1)
    buf = x_rep.new_zeros((B * (E * C + 1), D)).index_add(
        0, flat, x_rep.reshape(-1, D))
    return buf.reshape(B, E * C + 1, D)[:, : E * C].reshape(B, E, C, D)


def _combine(out_buf, slot, gate, k: int) -> torch.Tensor:
    """Each row's choices read back from its slots (the spill row reads
    zeros), weighted by the gate and summed over the k choices:
    (B, S, D)."""
    B, E, C, D = out_buf.shape
    out_flat = torch.cat([out_buf.reshape(B, E * C, D),
                          out_buf.new_zeros((B, 1, D))], 1)
    gathered = out_flat.gather(1, slot[..., None].expand(*slot.shape, D))
    return (gathered * gate[..., None]).reshape(
        B, slot.shape[1] // k, k, D).sum(2)


def _per_row(fn, shape: tuple, *args):
    """``fn(*args)``; on DTensors, on each rank's batch rows as plain
    tensors (the slots index within a row, and DTensor's index_add and
    gather over a sharded batch miscount their local rows), the result a
    DTensor of global ``shape`` sharded on the batch over dp. A tensor
    argument is taken whole but for its batch rows (the combine gathers
    the expert buffers over TP, as its slots may name any expert)."""
    if not _dtensor(args[0]):
        return fn(*args)
    local = [to_local_shards(a, "dp", *([None] * (a.dim() - 1)))
             if isinstance(a, torch.Tensor) else a for a in args]
    return from_local_shards(fn(*local), args[0].device_mesh, shape, "dp",
                             *([None] * (len(shape) - 1)))


def moe_forward(p: dict, cfg, x: torch.Tensor
                ) -> tuple[torch.Tensor, MoEStats]:
    """x: (B, S, D). Returns (out (B, S, D), stats with the Switch balance
    loss ``E · Σ_e f_e · m_e`` over the top-1 choices, and the routing)."""
    B, S, D = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    C = moe_capacity(S, k, E, cfg.moe_capacity_factor)
    mode, db, wb = _alpha_mode(cfg, B, S)
    r = moe_route(p, cfg, x)

    me = r.probs.mean((0, 1))                                   # (E,)
    fe = F.one_hot(r.top_e[..., 0], E).float().mean((0, 1))
    aux = E * (fe * me).sum()

    keep_x = r.keep[..., None].to(x.dtype)
    x_rep = torch.repeat_interleave(x, k, 1) * keep_x            # (B,N,D)
    buf = _per_row(_dispatch, (B, E, C, D), x_rep, r.slot, E, C)

    wg, wu, wd = (gather_fsdp(p[k]) for k in ("wg", "wu", "wd"))
    if mode == "tokens":
        buf = shard(buf, "dp", "tp", None, None)
        wg = shard(wg, "tp", None, None)
        wu = shard(wu, "tp", None, None)
        wd = shard(wd, "tp", None, None)
    else:
        buf = shard(buf, "dp", None, None, None)
        wg = shard(wg, None, None, "tp")
        wu = shard(wu, None, None, "tp")
        wd = shard(wd, None, "tp", None)
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg)) \
        * torch.einsum("becd,edf->becf", buf, wu)
    out_buf = torch.einsum("becf,efd->becd", h, wd)              # (B,E,C,D)
    if mode == "tokens":
        out_buf = shard(out_buf, "dp", "tp", None, None)

    gate = (r.top_p.reshape(B, S * k) * r.keep).to(x.dtype)
    routed = _per_row(_combine, (B, S, D), out_buf, r.slot, gate, k)
    routed = shard(routed, "dp", None, None)
    if "shared" in p:
        routed = routed + mlp_forward(p["shared"], x, "swiglu")
    return routed, MoEStats(aux_loss=aux, dispatch_bytes=db,
                            weight_bytes=wb, mode=mode, routing=r)
