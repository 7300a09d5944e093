"""repro_torch.cache — degree-aware remote-feature cache with
deterministic epoch prefetch: admission policies (:mod:`policy`), the
device-resident padded cache table (:mod:`store`; also the serving path's
hot tier), and the epoch prefetcher that computes next epoch's hot sets
ahead of time (:mod:`prefetch`)."""
from repro_torch.cache.policy import (DegreePolicy, LFUPolicy, budget_rows,
                                      make_policy)
from repro_torch.cache.prefetch import EpochPrefetcher
from repro_torch.cache.store import CacheIndex, CacheStore

__all__ = ["CacheIndex", "CacheStore", "DegreePolicy", "LFUPolicy",
           "EpochPrefetcher", "budget_rows", "make_policy"]
