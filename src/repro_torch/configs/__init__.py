"""Architecture registry of the port.

``get_config(arch_id)`` returns the exact published configuration of each
of the reference's ten architectures (``dense``: qwen2-1.5b, qwen2.5-3b,
h2o-danube-3-4b, nemotron-4-340b; ``moe``: deepseek-moe-16b,
qwen2-moe-a2.7b; ``ssm``: rwkv6-7b; ``hybrid``: recurrentgemma-9b;
``vlm``: pixtral-12b; ``audio``: whisper-base); ``smoke_variant(cfg)``
returns the reduced same-family variant the CPU tests use (≤2 layers or
one pattern period, d_model ≤ 256, ≤4 experts, small vocab). The
reference's ``input_specs``/``SHAPES`` belong to its dry run and have no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer.config import ArchConfig

_MODULES = {
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "pixtral-12b": "pixtral_12b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen2.5-3b": "qwen2_5_3b",
    "whisper-base": "whisper_base",
    "qwen2-1.5b": "qwen2_1_5b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant, as the reference's: ≤2 layers,
    d_model ≤ 256, d_ff ≤ 512, vocab ≤ 512, float32; ≤4 query heads (KV
    heads as many, or half as many where the config groups them), head dim
    d_model / heads, a 64-token sliding window where the config has one;
    4 experts (top-k ≤ 2, ≤ 1 shared, expert d_ff 128); one pattern period
    for a hybrid (RG-LRU width d_model, a 32-token local window); head dim
    32 for RWKV6; a 2-layer encoder over 64 frames for audio; 16 patches of
    width 64 for vlm."""
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
    if cfg.moe_num_experts:
        kw["moe_num_experts"] = 4
        kw["moe_top_k"] = min(cfg.moe_top_k, 2)
        kw["moe_num_shared"] = min(cfg.moe_num_shared, 1)
        kw["moe_expert_d_ff"] = 128
    if cfg.family == "hybrid":
        kw["num_layers"] = len(tuple(cfg.block_pattern))   # one full period
        kw["rglru_width"] = kw["d_model"]
        kw["local_attn_window"] = 32
    if cfg.family == "ssm":
        kw["rwkv_head_dim"] = 32
    if cfg.family == "audio":
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 64
        kw["encoder_d_model"] = kw["d_model"]
    if cfg.family == "vlm":
        kw["num_patches"] = 16
        kw["patch_dim"] = 64
    return dataclasses.replace(cfg, **kw)
