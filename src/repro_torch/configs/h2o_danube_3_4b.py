"""h2o-danube-3-4b — dense llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    swa_window=4096, mlp="swiglu", rope_theta=10_000.0,
    source="arXiv:2401.16818",
)
