"""Architecture registry of the port.

``get_config(arch_id)`` returns the exact published configuration of each
of the reference's ten architectures (``dense``: qwen2-1.5b, qwen2.5-3b,
h2o-danube-3-4b, nemotron-4-340b; ``moe``: deepseek-moe-16b,
qwen2-moe-a2.7b; ``ssm``: rwkv6-7b; ``hybrid``: recurrentgemma-9b;
``vlm``: pixtral-12b; ``audio``: whisper-base); ``smoke_variant(cfg)``
returns the reduced same-family variant the CPU tests use (≤2 layers or
one pattern period, d_model ≤ 256, ≤4 experts, small vocab).
``SHAPES`` names the reference's four input shapes, ``shape_applicable``
says whether an architecture runs one, and ``input_specs(cfg, shape)``
returns stand-ins for every data input of a step as tensors on the
``meta`` device (the reference's ``ShapeDtypeStruct``s): shapes and dtypes,
no storage.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

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


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason). long_500k requires sub-quadratic decode state."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full attention: a 524288-token KV cache is O(S) "
                       "per token with O(S) HBM — skipped per DESIGN.md §4")
    return True, ""


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


def input_specs(cfg: ArchConfig, shape_name: str,
                seq: Optional[int] = None,
                batch: Optional[int] = None) -> dict:
    """Stand-ins for the *data* inputs of a step: tensors on the ``meta``
    device with the reference's shapes and dtypes (token ids int32,
    patches and frames in ``cfg.activation_dtype``).

    train/prefill → the forward batch dict; decode → {"token": (B,)}.
    """
    sh = SHAPES[shape_name]
    S = seq if seq is not None else sh.seq_len
    B = batch if batch is not None else sh.global_batch

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    act = cfg.activation_dtype
    if sh.kind == "decode":
        return {"token": spec((B,), i32)}
    specs: dict = {}
    if cfg.family == "vlm":
        P = min(cfg.num_patches, max(S // 4, 1))
        specs["patches"] = spec((B, P, cfg.patch_dim), act)
        specs["tokens"] = spec((B, S - P), i32)
    elif cfg.family == "audio":
        De = cfg.encoder_d_model or cfg.d_model
        specs["frames"] = spec((B, cfg.encoder_seq, De), act)
        specs["tokens"] = spec((B, S), i32)
    else:
        specs["tokens"] = spec((B, S), i32)
    return specs
