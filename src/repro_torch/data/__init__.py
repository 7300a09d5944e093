"""Synthetic token batches for the transformer side workload."""
from repro_torch.data.pipeline import make_batch, token_batches

__all__ = ["make_batch", "token_batches"]
