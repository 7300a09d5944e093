"""deepseek-moe-16b — fine-grained experts: 2 shared + 64 routed, top-6.
[arXiv:2401.06066]"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    mlp="swiglu",
    moe_num_experts=64, moe_top_k=6, moe_num_shared=2,
    moe_expert_d_ff=1408, moe_dispatch="auto",
    source="arXiv:2401.06066",
)
