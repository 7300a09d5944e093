"""repro_torch.features — tiered feature storage (device cache → host hot tier →
mmap disk). See store.py for the tier contract."""
from repro_torch.features.store import (CorruptFeatureError, FeatureStore,
                                  TierStats, spill_shards)

__all__ = ["FeatureStore", "TierStats", "spill_shards",
           "CorruptFeatureError"]
