"""Transformer side workload of the port, served and trained: every
family of the reference — dense GQA (sliding window, KV cache), MoE,
RWKV6 (``ssm``), the RG-LRU hybrid, whisper-style audio and the VLM.
"""
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.model import (
    DecodeState, chunked_ce, decode_step, forward, forward_hidden,
    init_decode_state, init_params, loss_fn, params_from_jax, prefill)

__all__ = ["ArchConfig", "DecodeState", "chunked_ce", "decode_step",
           "forward", "forward_hidden", "init_decode_state", "init_params",
           "loss_fn", "params_from_jax", "prefill"]
