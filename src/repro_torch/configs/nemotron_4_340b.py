"""nemotron-4-340b — dense GQA with squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    mlp="sqrelu", rope_theta=10_000.0,
    source="arXiv:2402.16819",
)
