"""whisper-base — encoder-decoder audio backbone; conv/mel frontend is a
STUB (make_batch supplies frame embeddings). [arXiv:2212.04356]"""
from repro_torch.models.transformer.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    mlp="gelu",
    encoder_layers=6, encoder_seq=1500, encoder_d_model=512,
    source="arXiv:2212.04356",
)
