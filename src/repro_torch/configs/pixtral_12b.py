"""pixtral-12b — Pixtral-ViT (stubbed) + mistral-nemo decoder backbone.
[hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072,
    mlp="swiglu", rope_theta=1_000_000.0,
    num_patches=1024, patch_dim=1024,     # stub ViT output (P, 1024)
    source="hf:mistralai/Pixtral-12B-2409",
)
