"""Architecture registry of the port.

``get_config(arch_id)`` returns the exact published configuration;
``smoke_variant(cfg)`` returns the reduced same-family variant the CPU
tests use (≤2 layers, d_model ≤ 256, small vocab). Only the families the
port runs are listed (``dense``: qwen2-1.5b, qwen2.5-3b, h2o-danube-3-4b,
nemotron-4-340b; ``ssm``: rwkv6-7b); asking for another architecture of the
reference raises ``KeyError`` naming the ROADMAP item that ports it.
The reference's ``input_specs``/``SHAPES`` belong to its dry run and have
no counterpart here.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer.config import ArchConfig

_MODULES = {
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen2-1.5b": "qwen2_1_5b",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is unknown or not ported yet "
                       f"(ROADMAP.md, Queue 1 item 9 ports the reference's "
                       f"other families); have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant, as the reference's: ≤2 layers,
    d_model ≤ 256, d_ff ≤ 512, vocab ≤ 512, float32; ≤4 query heads (KV
    heads as many, or half as many where the config groups them), head dim
    d_model / heads, a 64-token sliding window where the config has one,
    and head dim 32 for RWKV6. The reference's branches for the families
    the port does not run yet (experts, hybrid, audio, vlm) arrive with
    them."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2),
        d_model=min(cfg.d_model, 256),
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        vocab_pad_to=128,
        dtype="float32",
    )
    if cfg.num_heads:
        heads = min(cfg.num_heads, 4)
        kw["num_heads"] = heads
        kw["num_kv_heads"] = max(1, min(cfg.num_kv_heads,
                                        heads if cfg.num_kv_heads >= cfg.num_heads
                                        else max(1, heads // 2)))
        kw["head_dim"] = kw["d_model"] // heads
    if cfg.swa_window:
        kw["swa_window"] = 64
    if cfg.family == "ssm":
        kw["rwkv_head_dim"] = 32
    return dataclasses.replace(cfg, **kw)
