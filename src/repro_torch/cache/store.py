"""Device-resident remote-feature cache table.

A :class:`CacheStore` holds, per shard, a padded table of *remote* feature
rows chosen by an admission policy (repro_torch.cache.policy): shard s's slice
``table[s]`` is ``(c_max, d)`` with the cached rows packed in id-sorted
order and zero padding above. The host-side :class:`CacheIndex` is the
SlotMap-style lookup structure the planner consults: per-shard sorted
global-id arrays with aligned slot arrays, so a hit test is one
``searchsorted`` per shard.

Shapes are quantized: ``c_max`` is a power-of-two bucket (the budget's
``next_bucket``, shared so the two can never drift), grown only when an
installed selection outgrows it — cache-*content* refreshes never change
device shapes, so the forward over ``[cached | fetched]`` never retraces
across refreshes. ``version`` increments on every install; plans
record the version they were built against and the Trainer refuses to
execute a stale plan (features are static during training, so cached rows
are always *exact* copies — versioning guards index/table agreement, not
value staleness).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import span as _obs_span
from repro_torch.train.budget import next_bucket as _next_pow2


@dataclasses.dataclass
class CacheIndex:
    """Host-side cached-set lookup: which remote ids shard s holds, and in
    which cache-table row. ``ids[s]`` is sorted ascending; ``slots[s]`` is
    aligned and points into ``[0, c_max)``."""

    ids: list[np.ndarray]      # per shard, sorted unique global vertex ids
    slots: list[np.ndarray]    # per shard, aligned cache-table row
    c_max: int                 # padded table height (power of two, or 0)
    version: int = 0

    @property
    def num_shards(self) -> int:
        return len(self.ids)

    def num_cached(self, shard: int) -> int:
        return int(self.ids[shard].size)

    def hit_split(self, shard: int, query: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
        """(hit_mask, hit_slots) for sorted-or-not ``query`` ids on ``shard``.
        ``hit_slots`` is aligned with ``query`` and valid where the mask is
        True (0 elsewhere). Fully vectorized — one searchsorted."""
        query = np.asarray(query, np.int64)
        cids = self.ids[shard]
        hit = np.zeros(query.size, bool)
        slot = np.zeros(query.size, np.int64)
        if cids.size and query.size:
            pos = np.searchsorted(cids, query)
            ok = (pos < cids.size) & \
                (cids[np.minimum(pos, cids.size - 1)] == query)
            hit = ok
            slot[ok] = self.slots[shard][pos[ok]]
        return hit, slot

    @staticmethod
    def empty(num_shards: int) -> "CacheIndex":
        z = [np.zeros(0, np.int64) for _ in range(num_shards)]
        return CacheIndex(ids=z, slots=[a.copy() for a in z], c_max=0,
                          version=0)


class CacheStore:
    """Padded per-shard cache table + its index, versioned.

    The device tensor lives on the store's explicit ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``). It is uploaded
    lazily (``device_table``) and re-uploaded only after :meth:`install` —
    between refreshes the table stays resident. ``c_max`` may be pre-sized
    (``CacheStore(..., c_max=next_bucket(budget_rows))``) so even a cold
    (empty) cache already has its final device shape — the compile-once
    pattern the Trainer uses.

    Under a device mesh (``shard`` = this rank) the index and the host
    table still cover every shard — each rank plans the whole iteration —
    but only the rank's ``(1, c_max, d)`` slice is uploaded.
    """

    def __init__(self, num_shards: int, feature_dim: int, c_max: int = 0,
                 dtype=np.float32, device=None, shard=None):
        self.device = resolve_device(device)
        self.shard = shard
        self.num_shards = int(num_shards)
        self.feature_dim = int(feature_dim)
        self.dtype = np.dtype(dtype)
        self.c_max = _next_pow2(c_max) if c_max else 0
        self.version = 0
        self.index = CacheIndex.empty(self.num_shards)
        self.index.c_max = self.c_max
        self._host = np.zeros((self.num_shards, self.c_max, self.feature_dim),
                              self.dtype)
        self._device = None          # uploaded lazily, invalidated on install
        self.installs = 0
        self.repads = 0              # c_max re-buckets (shape changes)

    # ------------------------------------------------------------------

    @property
    def device_table(self):
        """(N, c_max, d) tensor on ``device`` — (1, c_max, d), the shard's
        slice, with a ``shard`` — cached across calls until an install.
        Pre-sized to ``c_max``, so a refresh never changes shapes."""
        if self._device is None:
            host = (self._host if self.shard is None
                    else self._host[self.shard:self.shard + 1])
            with _obs_span("cache.upload", bytes=int(host.nbytes)):
                self._device = torch.from_numpy(host).to(self.device)
            _obs_metrics.inc("cache.upload_bytes", int(host.nbytes))
        return self._device

    def nbytes(self) -> int:
        return int(self._host.nbytes)

    def rows_installed(self) -> int:
        return int(sum(i.size for i in self.index.ids))

    # ------------------------------------------------------------------

    def install(self, ids_per_shard: list[np.ndarray],
                rows_per_shard: list[np.ndarray]) -> dict:
        """Replace the cached set: ``rows_per_shard[s][k]`` is the feature
        row of ``ids_per_shard[s][k]`` (any order; sorted here). Grows
        ``c_max`` to the next power-of-two bucket only when the selection
        outgrows the current one (counted in ``repads`` — each re-pad is a
        device-shape change and therefore one new jit trace downstream).
        Returns install stats for the Trainer's epoch accounting."""
        assert len(ids_per_shard) == self.num_shards
        k_max = max((np.asarray(i).size for i in ids_per_shard), default=0)
        if k_max > self.c_max:
            self.c_max = _next_pow2(k_max, self.c_max + 1)
            self.repads += 1
        host = np.zeros((self.num_shards, self.c_max, self.feature_dim),
                        self.dtype)
        ids_s, slots_s = [], []
        rows_total = 0
        for s in range(self.num_shards):
            ids = np.asarray(ids_per_shard[s], np.int64)
            rows = np.asarray(rows_per_shard[s], self.dtype)
            assert rows.shape[0] == ids.size, (rows.shape, ids.size)
            order = np.argsort(ids)
            ids = ids[order]
            if ids.size and np.any(np.diff(ids) == 0):
                raise ValueError(f"duplicate cached ids on shard {s}")
            host[s, :ids.size] = rows[order]
            ids_s.append(ids)
            slots_s.append(np.arange(ids.size, dtype=np.int64))
            rows_total += int(ids.size)
        self.version += 1
        self.installs += 1
        self.index = CacheIndex(ids=ids_s, slots=slots_s, c_max=self.c_max,
                                version=self.version)
        self._host = host
        self._device = None
        _obs_metrics.inc("cache.installs")
        _obs_metrics.inc("cache.rows_installed", rows_total)
        if self.repads:
            _obs_metrics.registry().gauge("cache.repads").set(self.repads)
        return {"rows": rows_total, "bytes": rows_total * self.feature_dim
                * self.dtype.itemsize, "c_max": self.c_max,
                "version": self.version}

    def install_from(self, feature_store,
                     ids_per_shard: list[np.ndarray]) -> dict:
        """Refresh the cached set straight from a
        :class:`repro_torch.features.FeatureStore`: the selected rows are
        resolved through the store's tier chain (host hot tier → mmap
        disk) instead of a caller-held dense host copy — the tier-0
        refresh path of the feature hierarchy. The store must have bound
        owner/local_idx maps (``take_global``)."""
        with _obs_span("cache.install",
                       rows=int(sum(np.asarray(i).size
                                    for i in ids_per_shard))):
            rows = [feature_store.take_global(ids)
                    for ids in ids_per_shard]
            return self.install(ids_per_shard, rows)
