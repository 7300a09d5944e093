"""repro_torch.cache — admission policies and the device-resident cache
table (the serving path's hot feature tier). The epoch prefetcher
(``repro.cache.prefetch``) arrives with the training slice."""
from repro_torch.cache.policy import (DegreePolicy, LFUPolicy, budget_rows,
                                      make_policy)
from repro_torch.cache.store import CacheIndex, CacheStore

__all__ = ["CacheIndex", "CacheStore", "DegreePolicy", "LFUPolicy",
           "budget_rows", "make_policy"]
