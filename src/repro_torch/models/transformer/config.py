"""Architecture configuration for the transformer side workload.

The port's copy of the reference's ``ArchConfig``: one frozen dataclass
for every family the reference spans (dense GQA, MoE, attention-free SSM
(RWKV6), hybrid recurrent, encoder-decoder audio, VLM), so configs and
parameter counts carry across unchanged; the port runs every family.
``src/repro_torch/configs/<id>.py`` instantiates the published numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention options ---
    head_dim: Optional[int] = None          # default d_model // num_heads
    qkv_bias: bool = False                  # qwen2 family
    swa_window: Optional[int] = None        # sliding-window attention
    rope_theta: float = 10_000.0

    # --- MLP options ---
    mlp: str = "swiglu"           # swiglu | sqrelu | gelu
    # --- MoE options ---
    moe_num_experts: int = 0               # routed experts (0 = dense MLP)
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_expert_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "tokens"           # tokens | weights | auto (HopMoE α)

    # --- hybrid / ssm options ---
    block_pattern: Optional[Sequence[str]] = None   # e.g. ("rec","rec","attn")
    rglru_width: int = 0                   # RG-LRU recurrence width (=d_model)
    local_attn_window: int = 2048
    conv_width: int = 4
    rwkv_head_dim: int = 64

    # --- encoder-decoder / multimodal options ---
    encoder_layers: int = 0                # whisper encoder depth
    encoder_seq: int = 0                   # stub frontend output length
    encoder_d_model: int = 0
    num_patches: int = 0                   # VLM stub patch count (train shape)
    patch_dim: int = 0                     # stub patch embedding width

    # --- sharding/perf knobs (§Perf) ---
    kv_tp_repeat: int = 1      # replicate KV heads so K·rep divides the TP
    #                            axis — standard GQA-under-TP practice; kills
    #                            GSPMD's mixed 2-axis head split (§Perf it.)

    # --- training ---
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    vocab_pad_to: int = 2048               # Megatron-style padded vocab shard

    # --- citation ---
    source: str = ""

    @property
    def hdim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return (self.vocab_size + m - 1) // m * m

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context (bounded per-token state)?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.swa_window is not None

    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        total = V * D                                  # embed
        if not self.tie_embeddings:
            total += V * D                             # lm head
        per_layer = 0
        if self.family == "ssm":
            H = D // self.rwkv_head_dim
            # rwkv6: r,k,v,g,o projections + decay/ln params + channel mix
            per_layer = 5 * D * D + 2 * D * 64 + 2 * D + D // 1 \
                + D * F + F * D + D * D
        else:
            kv = self.num_kv_heads * self.hdim
            q = self.num_heads * self.hdim
            attn = D * q + 2 * D * kv + q * D
            if self.mlp == "swiglu":
                mlp = 3 * D * F
            else:
                mlp = 2 * D * F
            if self.moe_num_experts:
                fe = self.moe_expert_d_ff
                routed = self.moe_num_experts * 3 * D * fe
                shared = self.moe_num_shared * 3 * D * fe
                mlp = routed + shared + D * self.moe_num_experts
            per_layer = attn + mlp + 2 * D
        total += self.num_layers * per_layer
        if self.encoder_layers:
            De = self.encoder_d_model or D
            enc = self.encoder_layers * (4 * De * De + 2 * De * (4 * De) + 2 * De)
            total += enc + self.num_layers * (2 * De * D + 2 * D * self.hdim * self.num_heads)
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: shared + top-k routed)."""
        if not self.moe_num_experts:
            return self.param_count()
        D, fe = self.d_model, self.moe_expert_d_ff
        inactive = (self.moe_num_experts - self.moe_top_k) * 3 * D * fe
        return int(self.param_count() - self.num_layers * inactive)
