"""Cache admission policies (repro_torch.cache tentpole, part a).

A policy chooses, per shard, which *remote* vertices to keep resident under
a byte budget. Two families, mirroring RapidGNN's findings (PAPERS.md,
arXiv 2505.10806 / 2509.05207):

* :class:`DegreePolicy` — static, structural: the highest-degree vertices
  of a power-law graph dominate sampled neighborhoods, so the top-degree
  remote vertices of each shard are cached once and never refreshed.
  Zero prediction cost; hit rate bounded by how head-heavy the degree
  distribution is.
* :class:`LFUPolicy` — epoch-frequency LFU: ranks candidates by how often
  each (shard, vertex) pair actually appeared in observed
  :class:`~repro_torch.core.pregather.GatherPlan` requests (one count per plan —
  pre-gathering dedups within an iteration, so the natural request unit is
  "shard s needed v this iteration"). The deterministic sampler lets the
  epoch prefetcher (repro_torch.cache.prefetch) feed *next*-epoch frequencies
  instead, making the LFU exact rather than trailing.

Budgets are expressed in bytes; :func:`budget_rows` converts to cacheable
rows for a feature width.
"""
from __future__ import annotations

import numpy as np


def budget_rows(budget_bytes: int, feature_dim: int, itemsize: int = 4) -> int:
    """How many feature rows a per-shard byte budget admits."""
    if budget_bytes <= 0 or feature_dim <= 0:
        return 0
    return int(budget_bytes) // (int(feature_dim) * int(itemsize))


def _top_k_by_score(ids: np.ndarray, score: np.ndarray, k: int) -> np.ndarray:
    """The k ids with the highest score; ties broken by smaller id so the
    selection (and therefore the cache layout and every downstream device
    shape) is deterministic."""
    ids = np.asarray(ids, np.int64)
    if k <= 0 or ids.size == 0:
        return np.zeros(0, np.int64)
    if ids.size <= k:
        return np.sort(ids)
    # lexsort: last key is primary → (-score, id) ascending
    order = np.lexsort((ids, -np.asarray(score)))
    return np.sort(ids[order[:k]])


class DegreePolicy:
    """Static degree-based admission from the :class:`CSRGraph` structure."""

    name = "degree"
    static = True          # selection never changes → one install, ever

    def __init__(self, graph, owner: np.ndarray):
        self._deg = np.asarray(graph.degrees(), np.int64)
        self._owner = np.asarray(owner)

    def select(self, shard: int, k: int,
               hot_ids: np.ndarray | None = None,
               hot_counts: np.ndarray | None = None) -> np.ndarray:
        """Top-k remote vertices by degree. ``hot_ids`` (when given — e.g.
        from the prefetcher) restricts candidates to vertices that will
        actually be requested; the static default considers every remote
        vertex."""
        if hot_ids is not None:
            cand = np.asarray(hot_ids, np.int64)
            cand = cand[self._owner[cand] != shard]
        else:
            cand = np.nonzero(self._owner != shard)[0].astype(np.int64)
        return _top_k_by_score(cand, self._deg[cand], k)


class LFUPolicy:
    """Epoch-frequency LFU over observed (or predicted) plan requests.

    Counts are kept per shard as merged sorted (ids, counts) arrays —
    O(observed ids) memory, independent of the global vertex count.
    ``decay`` down-weights history each ``select`` round so the policy
    tracks drift in the request distribution (1.0 = pure cumulative LFU).
    """

    name = "lfu"
    static = False

    def __init__(self, num_shards: int, decay: float = 0.5):
        self.num_shards = int(num_shards)
        self.decay = float(decay)
        self._ids = [np.zeros(0, np.int64) for _ in range(self.num_shards)]
        self._counts = [np.zeros(0, np.float64)
                        for _ in range(self.num_shards)]
        self.observed_plans = 0

    def observe(self, shard: int, ids: np.ndarray,
                counts: np.ndarray | None = None) -> None:
        """Merge one request batch (deduped remote ids of a plan, or a
        predicted-frequency table) into the shard's running counts."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        w = (np.ones(ids.size, np.float64) if counts is None
             else np.asarray(counts, np.float64))
        cat = np.concatenate([self._ids[shard], ids])
        wat = np.concatenate([self._counts[shard], w])
        uniq, inv = np.unique(cat, return_inverse=True)
        acc = np.zeros(uniq.size, np.float64)
        np.add.at(acc, inv, wat)
        self._ids[shard], self._counts[shard] = uniq, acc

    def observe_plan(self, plan) -> None:
        """Record every (shard, remote id) request of a GatherPlan — the
        plan's SlotMap already holds exactly the deduped per-shard remote
        sets, so observation is zero extra planning work."""
        sm = plan.slot_map
        for s in range(sm.num_shards):
            self.observe(s, sm.shard_ids(s))
        self.observed_plans += 1

    def select(self, shard: int, k: int,
               hot_ids: np.ndarray | None = None,
               hot_counts: np.ndarray | None = None) -> np.ndarray:
        """Top-k by frequency.

        With predicted next-epoch frequencies (``hot_ids``/``hot_counts``
        from the deterministic prefetcher) the forecast is *exact*, so it
        alone ranks the candidates — mixing in stale history could evict a
        vertex that will be requested in favor of one that won't. The
        forecast is still folded into the decayed history so a later
        ``select`` without a forecast (trailing mode, or a prefetch miss)
        has it to fall back on."""
        if self.decay != 1.0 and self._counts[shard].size:
            self._counts[shard] = self._counts[shard] * self.decay
        if hot_ids is not None:
            hot_ids = np.asarray(hot_ids, np.int64)
            hot_counts = (np.ones(hot_ids.size, np.float64)
                          if hot_counts is None
                          else np.asarray(hot_counts, np.float64))
            self.observe(shard, hot_ids, hot_counts)
            return _top_k_by_score(hot_ids, hot_counts, k)
        return _top_k_by_score(self._ids[shard], self._counts[shard], k)


def make_policy(name: str, *, graph=None, owner=None, num_shards: int = 0,
                decay: float = 0.5):
    """Factory used by the Trainer: ``"degree"`` | ``"lfu"``."""
    if name == "degree":
        if graph is None or owner is None:
            raise ValueError("degree policy needs graph and owner")
        return DegreePolicy(graph, owner)
    if name == "lfu":
        if num_shards <= 0:
            raise ValueError("lfu policy needs num_shards")
        return LFUPolicy(num_shards, decay=decay)
    raise ValueError(f"unknown cache policy {name!r}")
