"""recurrentgemma-9b — RG-LRU recurrent + local attention hybrid, pattern
(rec, rec, attn). [arXiv:2402.19427]"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    rglru_width=4096, local_attn_window=2048, conv_width=4,
    mlp="swiglu",
    source="arXiv:2402.19427",
)
