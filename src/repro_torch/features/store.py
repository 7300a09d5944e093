"""Tiered feature storage: one `FeatureStore` behind every feature consumer.

LeapGNN's premise is that features dominate and must stay put while models
move — so the feature side deserves a real storage hierarchy instead of a
bare host numpy array per shard. A :class:`FeatureStore` owns per-shard
feature rows across three tiers:

* **tier 0 — device cache** (repro_torch.cache): the padded ``(N, c_max, d)``
  remote-row table that already lives next to the compiled iteration. The
  store does not manage it directly — the planner's hit/miss split does —
  but the store is what the cache *refreshes from*
  (:meth:`repro_torch.cache.store.CacheStore.install_from`).
* **tier 1 — host hot tier**: per-shard row caches in host RAM, sized by
  ``host_budget_bytes`` and replaced wholesale by exact next-epoch
  readahead (:meth:`readahead`). On a real accelerator deployment these
  buffers would be pinned for DMA; on the CPU container they are ordinary
  aligned numpy arrays.
* **tier 2 — memory-mapped disk**: one ``.npy`` per shard
  (:func:`spill_shards`), read through ``np.memmap`` fancy indexing. Rows
  absent from the hot tier are served from here (counted — per-tier traffic
  is first-class accounting, see :class:`TierStats`).

Residency contract: ``host_budget_bytes <= 0`` means *unlimited* host
memory — the store is **resident**, :meth:`as_dense` returns the full
``(N, local_rows, d)`` table, and every consumer behaves exactly as it did
before this subsystem existed (the bit-identical back-compat gate). Any
positive budget makes the store **tiered**: the dense table is never
materialized, the Trainer switches to the streamed engine path
(repro_torch.core.distributed ``streamed=True``), and reads resolve hot-tier →
backing.

Thread contract: :meth:`gather`/:meth:`take_global` may be called
concurrently from the Trainer's plan-prefetch thread and its cache thread
(counters are lock-protected); :meth:`readahead` installs only at epoch
boundaries, when no plan is in flight, so hot-tier swaps never race reads.

Integrity (repro_torch.resilience): the disk tier can rot — a flipped bit in a
mmap row would otherwise train silently on garbage. With checksums enabled
(:meth:`enable_checksums`; on by default for spilled stores built via
:meth:`build`), every backing shard carries a per-chunk crc32 computed at
spill time. Reads off the backing tier (gather misses, readahead
promotion) verify the chunks they touch — memoized, so each chunk pays the
scan once until marked suspect — and a mismatch *quarantines* the chunk:
its rows are re-gathered from the authoritative source feature array
(:meth:`attach_source`), held as an in-RAM patch that shadows the rotten
disk region, and counted in :class:`TierStats`. No source attached means
the corruption is unrecoverable and reads raise
:class:`CorruptFeatureError` instead of returning garbage.
"""
from __future__ import annotations

import dataclasses
import threading
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as _obs_metrics


class CorruptFeatureError(RuntimeError):
    """Backing-tier checksum mismatch with no authoritative source to
    repair from (or a source that itself disagrees with the checksum)."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.site = "store"      # degradation-ladder routing key


@dataclasses.dataclass
class TierStats:
    """Cumulative row counters per tier (bytes = rows × row_bytes).

    ``t1_rows``/``t2_rows`` count *gather* traffic (hot-tier hits vs
    backing/disk reads on the miss path); ``readahead_rows`` counts the
    tier-2 → tier-1 promotion traffic separately so steady-state miss
    accounting is not polluted by the prefetch that prevents the misses.
    """

    t1_rows: int = 0
    t2_rows: int = 0
    readahead_rows: int = 0
    gathers: int = 0
    # integrity counters (repro_torch.resilience) — deliberately NOT part of
    # snapshot()/delta(), which are positional and consumed by the
    # streamed-engine byte accounting
    crc_checked_chunks: int = 0
    crc_failures: int = 0
    repaired_rows: int = 0

    def snapshot(self) -> tuple:
        return (self.t1_rows, self.t2_rows, self.readahead_rows, self.gathers)

    def delta(self, since: tuple) -> "TierStats":
        return TierStats(t1_rows=self.t1_rows - since[0],
                         t2_rows=self.t2_rows - since[1],
                         readahead_rows=self.readahead_rows - since[2],
                         gathers=self.gathers - since[3])


class _HotTier:
    """Per-shard wholesale-replacement row cache (tier 1).

    Same lookup idiom as the device cache's :class:`CacheIndex`: a sorted
    array of resident backing-row indices plus an aligned buffer, so a hit
    test is one ``searchsorted``. Wholesale replacement (no eviction
    bookkeeping) is the right shape here because the epoch prefetcher's
    *exact* forecast replaces the whole resident set at epoch boundaries —
    the same design the device cache uses.
    """

    def __init__(self, feature_dim: int, dtype):
        self.ids = np.zeros(0, np.int64)           # sorted backing rows
        self.buf = np.zeros((0, feature_dim), dtype)
        self.installs = 0

    @property
    def rows(self) -> int:
        return int(self.ids.size)

    def hit_split(self, query: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(hit_mask, buffer_positions) for backing-row indices ``query``."""
        query = np.asarray(query, np.int64)
        hit = np.zeros(query.size, bool)
        pos = np.zeros(query.size, np.int64)
        if self.ids.size and query.size:
            p = np.searchsorted(self.ids, query)
            ok = (p < self.ids.size) & \
                (self.ids[np.minimum(p, self.ids.size - 1)] == query)
            hit = ok
            pos[ok] = p[ok]
        return hit, pos

    def install(self, rows_idx: np.ndarray, rows: np.ndarray) -> None:
        order = np.argsort(rows_idx)
        self.ids = np.asarray(rows_idx, np.int64)[order]
        self.buf = np.ascontiguousarray(rows[order])
        self.installs += 1


class FeatureStore:
    """One tiered store for the per-shard feature rows of a training run.

    ``backing[s]`` is shard s's ``(local_rows, d)`` feature rows — a plain
    ndarray (in-RAM tier 2, used by tests and resident stores) or an
    ``np.memmap`` over a per-shard ``.npy`` (the out-of-core tier 2). All
    shards are rectangular (padded to the same ``local_rows``), mirroring
    the SPMD table layout the engine always used.
    """

    def __init__(self, backing: Sequence[np.ndarray], *,
                 host_budget_bytes: int = 0,
                 owner: Optional[np.ndarray] = None,
                 local_idx: Optional[np.ndarray] = None):
        assert len(backing) > 0 and all(b.ndim == 2 for b in backing)
        rows0, d0 = backing[0].shape
        assert all(b.shape == (rows0, d0) for b in backing), \
            "backing shards must be rectangular"
        self._backing = list(backing)
        self.num_shards = len(backing)
        self.local_rows = int(rows0)
        self.feature_dim = int(d0)
        self.dtype = np.dtype(backing[0].dtype)
        self.host_budget_bytes = int(host_budget_bytes)
        self.owner = None if owner is None else np.asarray(owner)
        self.local_idx = None if local_idx is None else np.asarray(local_idx)
        self.stats = TierStats()
        self._lock = threading.Lock()
        self._dense: Optional[np.ndarray] = None
        # --- integrity state (enable_checksums) ---
        self.crc_chunk_rows = 0
        self._crc: Optional[list[np.ndarray]] = None   # per-shard chunk crcs
        self._verified: list[set] = [set() for _ in range(self.num_shards)]
        self._patches: list[dict] = [{} for _ in range(self.num_shards)]
        self._source: Optional[np.ndarray] = None      # global feature rows
        self._shard_globals_cache: dict[int, np.ndarray] = {}
        self._crc_lock = threading.RLock()
        self._hot_bypass = False
        # residency: non-positive budget = unlimited host RAM = the
        # pre-refactor world (dense table, no hot tier, no streaming)
        self.resident = self.host_budget_bytes <= 0
        if self.resident:
            self.hot_rows = self.local_rows
            self._hot = None
        else:
            self.hot_rows = min(
                self.local_rows,
                self.host_budget_bytes
                // max(self.num_shards * self.row_bytes, 1))
            self._hot = [_HotTier(self.feature_dim, self.dtype)
                         for _ in range(self.num_shards)]

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def from_array(cls, table: np.ndarray, host_budget_bytes: int = 0,
                   owner: Optional[np.ndarray] = None,
                   local_idx: Optional[np.ndarray] = None) -> "FeatureStore":
        """Back-compat constructor: wrap the classic ``(N, local_rows, d)``
        sharded table. With the default budget the store is resident and
        every consumer behaves bit-identically to the pre-store code."""
        table = np.asarray(table)
        assert table.ndim == 3, f"expected (N, rows, d), got {table.shape}"
        st = cls([table[s] for s in range(table.shape[0])],
                 host_budget_bytes=host_budget_bytes, owner=owner,
                 local_idx=local_idx)
        if st.resident:
            st._dense = table
        return st

    @classmethod
    def build(cls, features: np.ndarray, part: np.ndarray, num_shards: int,
              directory: Optional[str] = None, host_budget_bytes: int = 0,
              chunk_rows: int = 1 << 16,
              checksums: Optional[bool] = None,
              crc_chunk_rows: int = 1024) -> "FeatureStore":
        """Shard ``features`` by ``part`` into a store.

        With ``directory`` the per-shard rows are scattered *chunked* into
        on-disk ``.npy`` memmaps (:func:`spill_shards`) — peak host memory
        is one chunk, so graphs larger than host RAM shard fine as long as
        ``features`` itself is a memmap (repro_torch.graph.synthetic's spill
        writer). Without it the shards live in RAM (the classic
        ``shard_features`` layout).

        ``checksums`` defaults to on for spilled (disk-tier) stores and off
        for in-RAM ones; the crcs are persisted as ``shard_*.crc32.npz``
        sidecars next to the shard files, and ``features`` is attached as
        the authoritative repair source."""
        from repro_torch.graph.partition import local_index_map
        owner, local_idx, max_sz = local_index_map(
            np.asarray(part), num_shards)
        if directory is None:
            table = np.zeros((num_shards, max_sz, features.shape[1]),
                             features.dtype)
            table[owner, local_idx] = features
            st = cls.from_array(table, host_budget_bytes=host_budget_bytes,
                                owner=owner, local_idx=local_idx)
            if checksums:
                st.attach_source(features)
                st.enable_checksums(crc_chunk_rows)
            return st
        backing = spill_shards(features, owner, local_idx, num_shards,
                               max_sz, directory, chunk_rows=chunk_rows)
        st = cls(backing, host_budget_bytes=host_budget_bytes,
                 owner=owner, local_idx=local_idx)
        if checksums is None or checksums:
            st.attach_source(features)
            st.enable_checksums(crc_chunk_rows, persist_dir=directory)
        return st

    def bind(self, owner: np.ndarray, local_idx: np.ndarray) -> "FeatureStore":
        """Attach the global-id → (owner, local row) maps
        (:meth:`take_global` needs them). Returns self for chaining."""
        self.owner = np.asarray(owner)
        self.local_idx = np.asarray(local_idx)
        return self

    def _reconstruct_source(self) -> np.ndarray:
        """Global feature rows recovered from the current backing through
        the bound owner/local_idx maps (crc-verified reads, patches
        honored). The reshard fallback when no authoritative source is
        attached."""
        if self.owner is None or self.local_idx is None:
            raise ValueError("reshard needs an attached source or bound "
                             "owner/local_idx maps (FeatureStore.bind)")
        n = int(self.owner.size)
        out = np.empty((n, self.feature_dim), self.dtype)
        for s in range(self.num_shards):
            ids = np.flatnonzero(self.owner == s)
            if ids.size:
                out[ids] = self._read_backing(
                    s, self.local_idx[ids].astype(np.int64))
        return out

    def reshard(self, part: np.ndarray, num_shards: int, *,
                directory: Optional[str] = None) -> "FeatureStore":
        """Rebuild the tier chain for a new world view (repro_torch.membership).

        After a confirmed peer death the survivors re-own the dead shard's
        vertices (``graph.partition.reassign_partition``) and every tier
        must be rebuilt for the new ``(part, num_shards)``: new rectangular
        backing, fresh hot tiers, fresh crc sidecars. Rows come from the
        authoritative source when one is attached — the same
        repair-from-source path disk corruption uses; on a real deployment
        this is the shared feature store the dead worker's rows survive
        in — otherwise the global rows are reconstructed from the *current*
        backing through the bound owner/local_idx maps, the single-process
        stand-in for survivors re-reading their local tiers.

        Returns a new bound store with the same host budget. ``directory``
        spills the new backing to disk — pass a fresh per-generation
        directory; the old shard files stay mapped until the old store is
        dropped."""
        src = self._source if self._source is not None \
            else self._reconstruct_source()
        st = FeatureStore.build(
            np.asarray(src), np.asarray(part), int(num_shards),
            directory=directory,
            host_budget_bytes=self.host_budget_bytes,
            checksums=self.checksums_enabled,
            crc_chunk_rows=self.crc_chunk_rows or 1024)
        if self._source is not None and st._source is None:
            st.attach_source(self._source)
        return st

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def row_bytes(self) -> int:
        return self.feature_dim * self.dtype.itemsize

    @property
    def spilled(self) -> bool:
        """True when tier 2 is disk-backed (any shard is a memmap)."""
        return any(isinstance(b, np.memmap) for b in self._backing)

    def backing_nbytes(self) -> int:
        return self.num_shards * self.local_rows * self.row_bytes

    def hot_nbytes(self) -> int:
        if self._hot is None:
            return self.backing_nbytes()
        return int(sum(h.buf.nbytes for h in self._hot))

    def hot_installed_rows(self, shard: int) -> int:
        return 0 if self._hot is None else self._hot[shard].rows

    def as_dense(self) -> np.ndarray:
        """The full ``(N, local_rows, d)`` host table — resident stores
        only (a tiered store materializing it would defeat the budget)."""
        if not self.resident:
            raise ValueError(
                f"store is tiered (host_budget_bytes="
                f"{self.host_budget_bytes}); the dense table would exceed "
                "the host budget — use gather()/take_global()")
        if self._dense is None:
            if self._crc is not None:
                # verified materialization — corruption must not leak into
                # the device table a resident run uploads once
                full = np.arange(self.local_rows, dtype=np.int64)
                self._dense = np.stack([self._read_backing(s, full)
                                        for s in range(self.num_shards)])
            else:
                self._dense = np.stack([np.asarray(b)
                                        for b in self._backing])
        return self._dense

    # ------------------------------------------------------------------
    # The read path (tier 1 -> tier 2)
    # ------------------------------------------------------------------

    def gather(self, shard: int, rows_idx: np.ndarray) -> np.ndarray:
        """Feature rows ``rows_idx`` (backing-row indices) of ``shard``,
        resolved hot-tier first, backing (disk) on miss. Duplicate indices
        are allowed and each occurrence is counted (they are real reads)."""
        rows_idx = np.asarray(rows_idx, np.int64)
        out = np.empty((rows_idx.size, self.feature_dim), self.dtype)
        if rows_idx.size == 0:
            return out
        if self._hot is None:                      # resident: all host RAM
            out[:] = self._read_backing(shard, rows_idx)
            self._acct_gather(int(rows_idx.size), 0)
            return out
        if self._hot_bypass:                       # degraded: tier 2 only
            out[:] = self._read_backing(shard, rows_idx)
            self._acct_gather(0, int(rows_idx.size))
            return out
        hot = self._hot[shard]
        hit, pos = hot.hit_split(rows_idx)
        n_hit = int(hit.sum())
        if n_hit:
            out[hit] = hot.buf[pos[hit]]
        if n_hit < rows_idx.size:
            miss = ~hit
            out[miss] = self._read_backing(shard, rows_idx[miss])
        self._acct_gather(n_hit, int(rows_idx.size) - n_hit)
        return out

    def _acct_gather(self, t1: int, t2: int) -> None:
        """One gather's tier accounting: the lock-scoped TierStats view
        and the process-wide repro_torch.obs registry move together."""
        with self._lock:
            self.stats.t1_rows += t1
            self.stats.t2_rows += t2
            self.stats.gathers += 1
        if t1:
            _obs_metrics.inc("features.t1_rows", t1)
        if t2:
            _obs_metrics.inc("features.t2_rows", t2)
        _obs_metrics.inc("features.gathers")

    def take_global(self, ids: np.ndarray) -> np.ndarray:
        """Feature rows by *global vertex id*, resolved through the tier
        chain — the store-backed replacement for the old
        ``table[owner[ids], local_idx[ids]]`` host-copy gather."""
        if self.owner is None or self.local_idx is None:
            raise ValueError("take_global needs bound owner/local_idx maps "
                             "(FeatureStore.bind)")
        ids = np.asarray(ids, np.int64)
        out = np.empty((ids.size, self.feature_dim), self.dtype)
        if ids.size == 0:
            return out
        own = self.owner[ids]
        for s in np.unique(own):
            m = own == s
            out[m] = self.gather(int(s), self.local_idx[ids[m]])
        return out

    # ------------------------------------------------------------------
    # Readahead (tier 2 -> tier 1)
    # ------------------------------------------------------------------

    def readahead(self, shard: int, rows_idx: np.ndarray,
                  counts: Optional[np.ndarray] = None) -> int:
        """Promote rows into the hot tier ahead of their reads.

        ``rows_idx`` are the backing rows a forecast says will be touched
        (the epoch prefetcher's exact next-epoch sets); ``counts`` ranks
        them when the set outgrows the budget — highest expected read count
        first, ties broken by row index for determinism. The install is
        wholesale (see :class:`_HotTier`). Returns rows installed."""
        if self._hot is None:
            return 0
        rows_idx = np.asarray(rows_idx, np.int64)
        if counts is not None:
            # counts are positional: sort rows (carrying counts along) and
            # require uniqueness — np.unique alone would silently misalign
            counts = np.asarray(counts)
            if counts.shape != rows_idx.shape:
                raise ValueError("counts must align with rows_idx")
            order = np.argsort(rows_idx, kind="stable")
            rows_idx, counts = rows_idx[order], counts[order]
            if rows_idx.size and np.any(np.diff(rows_idx) == 0):
                raise ValueError("rows_idx must be unique when ranked by "
                                 "counts")
            if rows_idx.size > self.hot_rows:
                keep = np.lexsort((rows_idx, -counts))[:self.hot_rows]
                rows_idx = np.sort(rows_idx[keep])
        else:
            rows_idx = np.unique(rows_idx)[:self.hot_rows]
        rows = np.empty((rows_idx.size, self.feature_dim), self.dtype)
        if rows_idx.size:
            rows[:] = self._read_backing(shard, rows_idx)
        self._hot[shard].install(rows_idx, rows)
        with self._lock:
            self.stats.readahead_rows += int(rows_idx.size)
        _obs_metrics.inc("features.readahead_rows", int(rows_idx.size))
        return int(rows_idx.size)

    # ------------------------------------------------------------------
    # Integrity: per-chunk crc32, quarantine, repair (repro_torch.resilience)
    # ------------------------------------------------------------------

    def enable_checksums(self, chunk_rows: int = 1024,
                         persist_dir: Optional[str] = None) -> None:
        """Compute (or load) per-chunk crc32s over every backing shard.

        A *chunk* is ``chunk_rows`` consecutive backing rows; the crc
        covers the chunk's raw bytes including padding rows, so repair can
        re-derive and re-verify it from the source exactly. With
        ``persist_dir``, crcs are written as ``shard_*.crc32.npz``
        sidecars (and loaded from them when present and chunk-compatible
        — reopening a spilled directory skips the rescan)."""
        self.crc_chunk_rows = int(chunk_rows)
        n_chunks = -(-self.local_rows // self.crc_chunk_rows)
        if persist_dir is not None and self._load_sidecars(persist_dir):
            return
        crcs = []
        for s in range(self.num_shards):
            c = np.empty(n_chunks, np.uint32)
            for k in range(n_chunks):
                c[k] = self._chunk_crc(s, k)
            crcs.append(c)
        self._crc = crcs
        self._verified = [set() for _ in range(self.num_shards)]
        if persist_dir is not None:
            self._write_sidecars(persist_dir)

    def _sidecar_path(self, directory, shard: int) -> Path:
        return Path(directory) / f"shard_{shard:03d}.crc32.npz"

    def _write_sidecars(self, directory) -> None:
        assert self._crc is not None
        for s in range(self.num_shards):
            np.savez(self._sidecar_path(directory, s), crc=self._crc[s],
                     chunk_rows=np.int64(self.crc_chunk_rows))

    def _load_sidecars(self, directory) -> bool:
        n_chunks = -(-self.local_rows // self.crc_chunk_rows)
        crcs = []
        for s in range(self.num_shards):
            p = self._sidecar_path(directory, s)
            if not p.exists():
                return False
            with np.load(p) as z:
                if int(z["chunk_rows"]) != self.crc_chunk_rows or \
                        z["crc"].size != n_chunks:
                    return False
                crcs.append(z["crc"].astype(np.uint32))
        self._crc = crcs
        self._verified = [set() for _ in range(self.num_shards)]
        return True

    def attach_source(self, features: np.ndarray) -> "FeatureStore":
        """Attach the authoritative global ``(n, d)`` feature rows (the
        pre-shard array or its memmap) as the repair source for
        checksum-failed chunks. Needs bound owner/local_idx maps to invert
        shard-local rows back to global ids. Returns self for chaining."""
        self._source = features
        return self

    @property
    def checksums_enabled(self) -> bool:
        return self._crc is not None

    @property
    def hot_bypass(self) -> bool:
        return self._hot_bypass

    def bypass_hot(self, flag: bool = True) -> None:
        """Degradation-ladder switch: route every gather straight to the
        (checksum-verified) backing tier, ignoring the hot tier. Used when
        a suspect hot-tier install must not serve reads; readahead still
        installs, so clearing the flag restores tiered service."""
        self._hot_bypass = bool(flag)

    def mark_suspect(self, shard: int,
                     rows_idx: Optional[np.ndarray] = None) -> None:
        """Drop verification memos for the chunks covering ``rows_idx``
        (whole shard when None) — the next read re-verifies them. This is
        the hook a scrubber or an EIO handler calls when it no longer
        trusts previously-verified disk regions."""
        with self._crc_lock:
            if self._crc is not None:
                self._dense = None     # re-materialize verified on next use
            if rows_idx is None:
                self._verified[shard] = set()
                return
            rows_idx = np.asarray(rows_idx, np.int64)
            for c in np.unique(rows_idx // max(self.crc_chunk_rows, 1)):
                self._verified[shard].discard(int(c))

    def corrupt_rows(self, shard: int, rows_idx: np.ndarray,
                     seed: int = 0) -> None:
        """Deterministically overwrite backing rows with garbage — the
        fault-injection entry point (repro_torch.resilience ``disk_corrupt``).
        Spilled shards are rewritten through a fresh r+ mapping of the
        same ``.npy`` so the store's read-only view observes the damage;
        the touched chunks are marked suspect so memoized verification
        does not mask it."""
        rows_idx = np.asarray(rows_idx, np.int64)
        if rows_idx.size == 0:
            return
        rng = np.random.default_rng(
            (int(seed) & 0x7FFFFFFF, shard, int(rows_idx[0])))
        garbage = rng.standard_normal(
            (rows_idx.size, self.feature_dim)) * 1e3
        b = self._backing[shard]
        if isinstance(b, np.memmap):
            from numpy.lib.format import open_memmap
            mm = open_memmap(b.filename, mode="r+")
            mm[rows_idx] = garbage.astype(self.dtype)
            mm.flush()
            del mm
        else:
            b[rows_idx] = garbage.astype(self.dtype)
        self.mark_suspect(shard, rows_idx)

    def verify_all(self) -> int:
        """Scrub every chunk of every shard now (repairing failures);
        returns the number of crc failures found."""
        if self._crc is None:
            return 0
        before = self.stats.crc_failures
        full = np.arange(self.local_rows, dtype=np.int64)
        for s in range(self.num_shards):
            self._check_rows(s, full)
        return self.stats.crc_failures - before

    def _chunk_bounds(self, chunk: int) -> tuple[int, int]:
        a = chunk * self.crc_chunk_rows
        return a, min(a + self.crc_chunk_rows, self.local_rows)

    def _chunk_crc(self, shard: int, chunk: int) -> int:
        a, b = self._chunk_bounds(chunk)
        block = np.ascontiguousarray(np.asarray(self._backing[shard][a:b]))
        return zlib.crc32(block.tobytes()) & 0xFFFFFFFF

    def _shard_globals(self, shard: int) -> np.ndarray:
        """Inverse map: shard-local backing row → global vertex id
        (−1 for padding rows). Cached per shard."""
        got = self._shard_globals_cache.get(shard)
        if got is not None:
            return got
        if self.owner is None or self.local_idx is None:
            raise CorruptFeatureError(
                "repair needs bound owner/local_idx maps (FeatureStore.bind)")
        inv = np.full(self.local_rows, -1, np.int64)
        ids = np.flatnonzero(self.owner == shard)
        inv[self.local_idx[ids]] = ids
        self._shard_globals_cache[shard] = inv
        return inv

    def _repair_chunk(self, shard: int, chunk: int) -> None:
        """Re-gather a checksum-failed chunk from the authoritative source
        into an in-RAM patch that shadows the rotten disk region. The
        rebuilt chunk must re-verify against the stored crc — if it does
        not, the source itself disagrees and we refuse to guess."""
        if self._source is None:
            raise CorruptFeatureError(
                f"shard {shard} chunk {chunk}: crc32 mismatch and no "
                "authoritative source attached (FeatureStore.attach_source)")
        a, b = self._chunk_bounds(chunk)
        glob = self._shard_globals(shard)[a:b]
        good = np.zeros((b - a, self.feature_dim), self.dtype)
        real = glob >= 0
        if real.any():
            good[real] = np.asarray(self._source[glob[real]],
                                    dtype=self.dtype)
        rebuilt = zlib.crc32(
            np.ascontiguousarray(good).tobytes()) & 0xFFFFFFFF
        if rebuilt != int(self._crc[shard][chunk]):
            raise CorruptFeatureError(
                f"shard {shard} chunk {chunk}: source re-gather does not "
                "match the recorded crc32 — source and sidecar disagree")
        self._patches[shard][chunk] = good
        with self._lock:
            self.stats.repaired_rows += int(real.sum())
        _obs_metrics.inc("features.repaired_rows", int(real.sum()))

    def _check_rows(self, shard: int, rows_idx: np.ndarray) -> None:
        """Verify (memoized) the chunks covering ``rows_idx``; quarantine
        and repair any that fail."""
        chunks = np.unique(rows_idx // self.crc_chunk_rows)
        verified = self._verified[shard]
        patches = self._patches[shard]
        todo = [int(c) for c in chunks
                if int(c) not in verified and int(c) not in patches]
        if not todo:
            return
        with self._crc_lock:
            for c in todo:
                if c in self._verified[shard] or c in patches:
                    continue       # another thread beat us to it
                got = self._chunk_crc(shard, c)
                with self._lock:
                    self.stats.crc_checked_chunks += 1
                _obs_metrics.inc("features.crc_checked_chunks")
                if got == int(self._crc[shard][c]):
                    self._verified[shard].add(c)
                    continue
                with self._lock:
                    self.stats.crc_failures += 1
                _obs_metrics.inc("features.crc_failures")
                self._repair_chunk(shard, c)

    def _read_backing(self, shard: int, rows_idx: np.ndarray) -> np.ndarray:
        """Tier-2 row read: crc-verify the touched chunks (when enabled)
        and serve quarantined chunks from their in-RAM patches instead of
        the rotten disk region."""
        if self._crc is not None:
            self._check_rows(shard, rows_idx)
        patches = self._patches[shard]
        if not patches:
            return self._backing[shard][rows_idx]
        ck = rows_idx // self.crc_chunk_rows
        out = np.empty((rows_idx.size, self.feature_dim), self.dtype)
        patched = np.isin(ck, np.fromiter(patches.keys(), np.int64,
                                          len(patches)))
        if (~patched).any():
            out[~patched] = self._backing[shard][rows_idx[~patched]]
        for c in np.unique(ck[patched]):
            m = ck == c
            out[m] = patches[int(c)][rows_idx[m] - int(c)
                                     * self.crc_chunk_rows]
        return out


def spill_shards(features: np.ndarray, owner: np.ndarray,
                 local_idx: np.ndarray, num_shards: int, max_sz: int,
                 directory: str, chunk_rows: int = 1 << 16
                 ) -> list[np.memmap]:
    """Scatter global feature rows into per-shard ``.npy`` memmaps.

    The scatter walks ``features`` in row chunks, so peak host memory is
    one chunk even when both the source (a spilled synthetic dataset) and
    the shards are disk-backed. Shards are padded to ``max_sz`` rows
    (rectangular, zero padding) exactly like ``shard_features``. The
    returned memmaps are reopened read-only — the store never writes
    tier 2 after construction (features are static during training)."""
    from numpy.lib.format import open_memmap
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    d = int(features.shape[1])
    paths = [directory / f"shard_{s:03d}.npy" for s in range(num_shards)]
    mms = [open_memmap(p, mode="w+", dtype=features.dtype,
                       shape=(max_sz, d)) for p in paths]
    n = int(features.shape[0])
    for a in range(0, n, chunk_rows):
        b = min(a + chunk_rows, n)
        chunk = np.asarray(features[a:b])
        own = owner[a:b]
        for s in np.unique(own):
            m = own == s
            mms[s][local_idx[a:b][m]] = chunk[m]
    for mm in mms:
        mm.flush()
    del mms
    return [np.load(p, mmap_mode="r") for p in paths]
