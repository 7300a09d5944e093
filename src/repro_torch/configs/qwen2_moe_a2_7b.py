"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    qkv_bias=True, mlp="swiglu",
    moe_num_experts=60, moe_top_k=4, moe_num_shared=4,
    moe_expert_d_ff=1408, moe_dispatch="auto",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
