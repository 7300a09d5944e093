"""Transformer side workload of the port: the RWKV6 (``ssm``) family so
far. The reference's other families (dense GQA, MoE, RG-LRU hybrid,
whisper-style audio, VLM) are still to port (ROADMAP.md, Queue 1 item 9).
"""
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.model import (
    DecodeState, decode_step, forward, init_decode_state, init_params,
    params_from_jax, prefill)

__all__ = ["ArchConfig", "DecodeState", "decode_step", "forward",
           "init_decode_state", "init_params", "params_from_jax", "prefill"]
