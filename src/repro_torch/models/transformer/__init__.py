"""Transformer side workload of the port: the dense GQA family (sliding
window, KV cache) and RWKV6 (``ssm``), served and trained. The reference's
other families (MoE, RG-LRU hybrid, whisper-style audio, VLM) are still to
port (ROADMAP.md, Queue 1 item 9).
"""
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.model import (
    DecodeState, chunked_ce, decode_step, forward, forward_hidden,
    init_decode_state, init_params, loss_fn, params_from_jax, prefill)

__all__ = ["ArchConfig", "DecodeState", "chunked_ce", "decode_step",
           "forward", "forward_hidden", "init_decode_state", "init_params",
           "loss_fn", "params_from_jax", "prefill"]
