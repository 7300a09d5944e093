"""Vertex feature pre-gathering (paper §5.2).

Given the tree blocks a server will train across *all* time steps of one
iteration, the full remote-vertex set is known before the first step.
Pre-gathering deduplicates it (a vertex used at steps t0 and t1 is fetched
once) and batches the per-peer fetches into a single exchange.

The exchange plan is expressed as rectangular arrays:
``req[s, p] : (R_max,)`` peer-local row indices shard s wants from shard p,
padded with 0; true counts ride along for exact byte accounting. The device
engine (repro_torch.core.distributed) turns this into the exchange of
indices out and feature rows back.

Cache-aware path (repro_torch.cache): when a resident :class:`CacheIndex`
is passed, each deduped remote id is first probed against the requesting
shard's cached set. Hits are translated to slots in the cached workspace
region (``[local_rows, local_rows + c_max)``) and never enter the
exchange; only misses are grouped into ``req``. Features are static during
training, so cached rows are exact and the split is numerics-neutral.

Planner hot path: plan construction is vectorized numpy — one
``np.unique`` over a flat ``(shard, id)`` key (or a presence bitmap) dedups
every shard at once, ``bincount``/``argsort`` produce the per-(shard, peer)
layout, and the global-id → workspace-slot translation is a
:class:`SlotMap` (``searchsorted`` over per-shard sorted id segments).
A copy of the reference's ``repro.core.pregather``, streamed-mode helpers
(a tiered FeatureStore) included; the plans are bitwise equal to the
reference's, and its per-vertex ``_reference_*`` oracles stay in the
reference (the port's tests hold the two against each other).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:                      # duck-typed at runtime (no core→cache
    from repro_torch.cache.store import CacheIndex   # import cycle risk)


class PlanOverflow(ValueError):
    """A rectangular plan array would not fit the requested shape budget.

    Carries which budgeted dimension overflowed (``"batch_pad"`` or
    ``"r_max"``) and the size actually needed, so callers (the
    ShapeBudget) can re-bucket precisely instead of parsing messages.
    """

    def __init__(self, field: str, needed: int, limit: int):
        super().__init__(f"{field} overflow: need {needed} > {field}={limit}")
        self.field = field
        self.needed = int(needed)
        self.limit = int(limit)


# Above this many vertices the per-shard dense translation cache is not
# built (memory guard: one int64 row of ``num_vertices`` per shard) and
# lookups stay on the searchsorted path.
_DENSE_LUT_MAX_VERTICES = 64_000_000

# The planner dedups via an (N, V) presence bitmap — O(ids + N·V) — when it
# fits this many cells (bool bytes) AND the id volume justifies the O(N·V)
# bitmap scan (see _use_bitmap_dedup); otherwise it falls back to the
# sort-based O(ids log ids) path. Tree-block id streams repeat heavily
# (fanout trees share neighbors), so the bitmap wins on dense workloads.
_DENSE_DEDUP_MAX_CELLS = 1 << 28


def _use_bitmap_dedup(n: int, V: int, total_ids: int) -> bool:
    """Bitmap dedup only when its O(n·V) scan is cheap in absolute terms
    or amortized by the id volume — a per-step plan with a few thousand
    ids on a 30M-vertex graph must not pay a 240MB bitmap per call."""
    cells = n * V
    if not 0 < cells <= _DENSE_DEDUP_MAX_CELLS:
        return False
    return cells <= (1 << 22) or cells <= total_ids * 16


@dataclasses.dataclass
class SlotMap:
    """Vectorized global-vertex-id → workspace-slot translation.

    Layout: the remote ids of all requesting shards live in one flat array,
    segmented per shard by ``starts`` (CSR-style offsets, length N+1).
    Within a shard's segment ``ids[starts[s]:starts[s+1]]`` is sorted
    ascending, so a lookup is ``searchsorted`` into the segment — O(log n)
    per query, fully vectorized over query batches, zero per-element Python.
    ``slots`` is aligned with ``ids`` and holds each id's workspace row.

    Hot-path cache: ``workspace_indices`` queries the same shard T × hops
    times per plan, so :meth:`translation_row` materializes one dense
    int32 ``num_vertices``-sized row per shard (local row index or remote
    slot at index v, -1 elsewhere) and every hop translation is a single
    gather. The cache is skipped above ``_DENSE_LUT_MAX_VERTICES`` (memory
    guard) or when ``num_vertices`` is unknown; the searchsorted
    :meth:`lookup` path is always valid.
    """

    starts: np.ndarray   # (N+1,) int64 — per-shard segment offsets
    ids: np.ndarray      # (M,) int64 — remote global ids, sorted per segment
    slots: np.ndarray    # (M,) int64 — workspace slot of ids[k]
    num_vertices: int = 0   # global id space size (0 = unknown, no cache)

    def __post_init__(self):
        self._trans: dict[int, np.ndarray] = {}

    @property
    def num_shards(self) -> int:
        return self.starts.size - 1

    def shard_ids(self, shard: int) -> np.ndarray:
        """Sorted remote global ids shard ``shard`` fetches."""
        return self.ids[self.starts[shard]:self.starts[shard + 1]]

    def shard_slots(self, shard: int) -> np.ndarray:
        """Workspace slots aligned with :meth:`shard_ids`."""
        return self.slots[self.starts[shard]:self.starts[shard + 1]]

    def cached_translation_row(self, shard: int) -> np.ndarray | None:
        """The shard's dense translation row if already built, else None —
        lets callers reuse a paid-for row even when the current query
        volume alone wouldn't justify building one."""
        return self._trans.get(shard)

    def translation_row(self, shard: int, owner: np.ndarray,
                        local_idx: np.ndarray) -> np.ndarray | None:
        """Full per-shard translation row: ``row[v]`` = workspace slot of
        global id v on ``shard`` — ``local_idx[v]`` for locally-owned v,
        the pre-gathered slot for fetched remote v, -1 for ids outside the
        plan. Turns a whole hop translation into ONE gather (no owner
        mask, no where, no searchsorted). Cached per shard; callers pass
        the same (owner, local_idx) the plan was built with. None above
        the memory guard — callers fall back to :meth:`lookup`."""
        if not (0 < self.num_vertices <= _DENSE_LUT_MAX_VERTICES):
            return None
        row = self._trans.get(shard)
        if row is None:
            # int32 on purpose: workspace rows fit comfortably, and the
            # hop translation gather moves half the bytes.
            row = np.where(np.asarray(owner) == shard,
                           np.asarray(local_idx, np.int32),
                           np.int32(-1))
            row[self.shard_ids(shard)] = self.shard_slots(shard)
            self._trans[shard] = row
        return row

    def lookup(self, shard: int, query: np.ndarray) -> np.ndarray:
        """Workspace slots for global ids ``query`` on ``shard``.

        Every queried id must be in the shard's remote set (callers filter
        local ids first); unknown ids raise rather than alias silently.
        """
        query = np.asarray(query, np.int64)
        lo, hi = int(self.starts[shard]), int(self.starts[shard + 1])
        seg = self.ids[lo:hi]
        if query.size and seg.size == 0:
            raise KeyError(
                f"ids not in shard {shard}'s remote set: {query[:8]}")
        pos = np.searchsorted(seg, query)
        if query.size:
            bad = (pos >= seg.size) \
                | (seg[np.minimum(pos, seg.size - 1)] != query)
            if np.any(bad):
                raise KeyError(f"ids not in shard {shard}'s remote set: "
                               f"{query[bad][:8]}")
        return self.slots[lo + pos]


@dataclasses.dataclass
class GatherPlan:
    """One exchange: requests + the workspace index of every remote vertex.

    With a cache (repro_torch.cache), the workspace on shard s is
    ``[local_rows local | c_max cached | P*r_max fetched]``: remote ids
    resident in the shard's cache table are *hits* (their slot points into
    the cached region; they never enter ``req``), the rest are *misses*
    shipped through the exchange as before. ``req``/``req_count``/``r_max``
    therefore describe miss traffic only.
    """

    req: np.ndarray          # (N, P, R_max) int32 — peer-local indices
    req_count: np.ndarray    # (N, P) int64 — true miss counts (accounting)
    r_max: int
    # global-vertex-id -> workspace slot, per requesting shard:
    #   hit:  slot(v) = local_rows + cache_slot(v)
    #   miss: slot(v) = local_rows + c_max + p * R_max + position
    slot_map: SlotMap
    c_max: int = 0                        # cached-region height (0 = no cache)
    cache_hits: Optional[np.ndarray] = None   # (N,) int64 hit rows per shard

    def remote_rows_exact(self) -> int:
        """Deduped remote rows actually shipped (misses only)."""
        return int(self.req_count.sum())

    def cache_hit_rows(self) -> int:
        """Deduped remote rows served from the resident cache."""
        return 0 if self.cache_hits is None else int(self.cache_hits.sum())

    def remote_rows_padded(self) -> int:
        n, p = self.req_count.shape
        return n * (p - 1) * self.r_max  # self-column carries no traffic


def build_gather_plan(needed_ids_per_shard: list[np.ndarray],
                      owner: np.ndarray, local_idx: np.ndarray,
                      num_shards: int, local_rows: int,
                      r_max: int | None = None,
                      cache: "Optional[CacheIndex]" = None) -> GatherPlan:
    """Build the deduplicated exchange plan (vectorized).

    needed_ids_per_shard[s]: every global vertex id shard s touches this
    iteration (may include duplicates; we dedup here — that *is* §5.2).

    All bookkeeping is flat numpy: ids are tagged with their requesting
    shard via a combined ``shard * V + id`` key, deduped in one
    ``np.unique``, split against the optional resident ``cache``
    (repro_torch.cache.CacheIndex — hits point into the cached workspace region
    and leave the exchange entirely), and the misses are grouped by owning
    peer and scattered into the rectangular ``req`` with one fancy-index
    store.
    """
    n = num_shards
    owner = np.asarray(owner)
    local_idx = np.asarray(local_idx)
    V = owner.size

    total_ids = sum(np.asarray(ids).size for ids in needed_ids_per_shard)
    if _use_bitmap_dedup(n, V, total_ids):
        # Bitmap dedup: mark[s, v] = shard s touches id v, then clear each
        # id's home cell (local ids need no fetch). np.nonzero walks the
        # bitmap row-major, handing back the dedup set already sorted by
        # (shard, id) — SlotMap's exact layout — in O(ids + n·V), with no
        # sort (and no concatenated copy) of the heavily duplicated raw
        # id stream.
        mark = np.zeros((n, V), bool)
        for s, ids in enumerate(needed_ids_per_shard):
            ids = np.asarray(ids)
            if ids.size:
                mark[s, ids.ravel()] = True
        mark[owner, np.arange(V)] = False
        u_shard, u_id = np.nonzero(mark)       # dedup set, (shard, id) order
    else:
        # Sort dedup: one combined (shard, id) key — a single np.unique
        # dedups per requesting shard and leaves the output in the
        # (shard, id) order SlotMap wants.
        sizes = [np.asarray(ids).size for ids in needed_ids_per_shard]
        if sum(sizes) == 0:
            flat = np.zeros(0, np.int64)
            shard = np.zeros(0, np.int64)
        else:
            flat = np.concatenate([np.asarray(ids, np.int64).ravel()
                                   for ids in needed_ids_per_shard])
            shard = np.repeat(np.arange(n, dtype=np.int64), sizes)
        own = owner[flat].astype(np.int64) if flat.size else flat
        remote = own != shard
        flat, shard = flat[remote], shard[remote]
        ukey = np.unique(shard * V + flat)
        u_shard, u_id = np.divmod(ukey, V)
    u_own = owner[u_id].astype(np.int64)

    # ---- cache split: hits leave the exchange ----
    c_max = int(cache.c_max) if cache is not None else 0
    hit = np.zeros(u_id.size, bool)
    slots_by_id = np.empty(u_id.size, np.int64)
    starts = np.concatenate(
        ([0], np.cumsum(np.bincount(u_shard, minlength=n))))
    if cache is not None and u_id.size:
        for s in range(n):
            lo, hi = int(starts[s]), int(starts[s + 1])
            if hi == lo:
                continue
            h, cslot = cache.hit_split(s, u_id[lo:hi])
            hit[lo:hi] = h
            idx = np.nonzero(h)[0] + lo
            slots_by_id[idx] = local_rows + cslot[h]
    cache_hits = np.bincount(u_shard[hit], minlength=n).astype(np.int64)

    # ---- misses: group by (shard, peer, id) and build the exchange ----
    miss_pos = np.nonzero(~hit)[0]
    s_m, p_m, v_m = u_shard[miss_pos], u_own[miss_pos], u_id[miss_pos]
    # a stable argsort over the small-range (shard, peer) key keeps ids
    # ascending within each (s, p) group
    order = np.argsort(s_m * n + p_m, kind="stable")
    s_o, p_o, v_o = s_m[order], p_m[order], v_m[order]

    counts = np.bincount(s_o * n + p_o,
                         minlength=n * n).reshape(n, n).astype(np.int64)
    if r_max is None:
        r_max = max(1, int(counts.max()))
    if counts.max() > r_max:
        raise PlanOverflow("r_max", int(counts.max()), int(r_max))

    # j-th id of a (s, p) group lands in req[s, p, j] and workspace slot
    # local_rows + c_max + p*r_max + j.
    group_start = np.concatenate(
        ([0], np.cumsum(counts.reshape(-1))))[:-1]
    j = np.arange(s_o.size, dtype=np.int64) - group_start[s_o * n + p_o]

    req = np.zeros((n, n, r_max), np.int32)
    req[s_o, p_o, j] = local_idx[v_o]

    # miss slots aligned back to the (shard, id)-sorted SlotMap layout
    slots_by_id[miss_pos[order]] = local_rows + c_max + p_o * r_max + j

    return GatherPlan(req=req, req_count=counts, r_max=r_max,
                      slot_map=SlotMap(starts=starts, ids=u_id,
                                       slots=slots_by_id, num_vertices=V),
                      c_max=c_max,
                      cache_hits=cache_hits if cache is not None else None)


def workspace_indices(hops: list[np.ndarray], shard: int,
                      owner: np.ndarray, local_idx: np.ndarray,
                      plan: GatherPlan) -> list[np.ndarray]:
    """Map global vertex ids of a tree block to workspace slots on ``shard``:
    locally-owned rows index the local table; remote rows index the
    pre-gathered region. Hot path is one gather per hop through the
    SlotMap's cached full translation row; above the row's memory guard it
    falls back to owner-mask + searchsorted (still zero per-element
    Python)."""
    out = []
    sm = plan.slot_map
    row = sm.cached_translation_row(shard)
    if row is None:
        # Building the dense row costs O(V); only pay it when this call's
        # id volume amortizes it (mirrors _use_bitmap_dedup's guard — a
        # few thousand ids on a 30M-vertex graph stay on searchsorted).
        total = sum(np.asarray(ids).size for ids in hops)
        V = sm.num_vertices
        if 0 < V and (V <= (1 << 22) or V <= total * 16):
            row = sm.translation_row(shard, owner, local_idx)
    for ids in hops:
        ids = np.asarray(ids)
        if row is not None:
            w = row[ids]                     # already int32
            if w.size and int(w.min()) < 0:
                raise KeyError(f"ids not in shard {shard}'s remote set: "
                               f"{ids[w < 0][:8]}")
            out.append(w)
            continue
        is_local = owner[ids] == shard
        w = np.where(is_local, local_idx[ids], 0).astype(np.int64)
        rem_pos = np.nonzero(~is_local)[0]
        if rem_pos.size:
            w[rem_pos] = plan.slot_map.lookup(shard,
                                              np.asarray(ids,
                                                         np.int64)[rem_pos])
        out.append(w.astype(np.int32))
    return out


# ---------------------------------------------------------------------------
# Streamed mode (repro_torch.features): compacted local region
# ---------------------------------------------------------------------------

def split_local_touched(needed_ids_per_shard: list[np.ndarray],
                        owner: np.ndarray,
                        l_max: int | None = None
                        ) -> tuple[list[np.ndarray], int]:
    """Per-shard sorted unique *locally-owned* ids an iteration touches.

    Streamed plans (a tiered FeatureStore instead of a device-resident
    table) cannot index the full local shard — only the iteration's
    touched local rows are uploaded, compacted into the first ``l_max``
    workspace rows. ``l_max`` is a budgeted dimension exactly like
    ``r_max``: ``None`` sizes it to this iteration's need; a too-small
    budget raises :class:`PlanOverflow("l_max")` for explicit re-bucketing.

    Returns (local_ids_per_shard, l_max): ``local_ids_per_shard[s]`` is
    sorted ascending, so global id ``local_ids_per_shard[s][k]`` lives in
    workspace row ``k`` on shard s.
    """
    owner = np.asarray(owner)
    loc: list[np.ndarray] = []
    for s, ids in enumerate(needed_ids_per_shard):
        ids = np.asarray(ids, np.int64).ravel()
        u = np.unique(ids) if ids.size else np.zeros(0, np.int64)
        loc.append(u[owner[u] == s] if u.size else u)
    need = max(1, max((u.size for u in loc), default=1))
    if l_max is None:
        l_max = need
    elif need > l_max:
        raise PlanOverflow("l_max", need, int(l_max))
    return loc, int(l_max)


def stream_workspace_indices(hops: list[np.ndarray], shard: int,
                             owner: np.ndarray,
                             local_ids: np.ndarray,
                             plan: GatherPlan) -> list[np.ndarray]:
    """Streamed-mode analogue of :func:`workspace_indices`: locally-owned
    ids map to their position in the shard's *compacted* touched-local
    region (``local_ids``, sorted — position = searchsorted rank) instead
    of a full-shard local row; remote ids resolve through the plan's
    SlotMap as usual (the plan was built with ``local_rows = l_max``, so
    remote slots already sit above the compacted region)."""
    out = []
    local_ids = np.asarray(local_ids, np.int64)
    owner = np.asarray(owner)
    sm = plan.slot_map
    # dense fast path: one row translating BOTH local compaction and remote
    # slots, amortized like workspace_indices' guard
    row = None
    V = sm.num_vertices
    total = sum(np.asarray(ids).size for ids in hops)
    if 0 < V <= _DENSE_LUT_MAX_VERTICES \
            and (V <= (1 << 22) or V <= total * 16):
        row = np.full(V, -1, np.int32)
        row[local_ids] = np.arange(local_ids.size, dtype=np.int32)
        row[sm.shard_ids(shard)] = sm.shard_slots(shard).astype(np.int32)
    for ids in hops:
        ids = np.asarray(ids, np.int64)
        if row is not None:
            w = row[ids]
            if w.size and int(w.min()) < 0:
                raise KeyError(f"ids not in shard {shard}'s touched set: "
                               f"{ids[w < 0][:8]}")
            out.append(w)
            continue
        is_local = owner[ids] == shard
        w = np.zeros(ids.size, np.int64)
        lpos = np.nonzero(is_local)[0]
        if lpos.size:
            p = np.searchsorted(local_ids, ids[lpos])
            bad = (p >= local_ids.size) \
                | (local_ids[np.minimum(p, local_ids.size - 1)]
                   != ids[lpos])
            if np.any(bad):
                raise KeyError(f"ids not in shard {shard}'s touched set: "
                               f"{ids[lpos][bad][:8]}")
            w[lpos] = p
        rpos = np.nonzero(~is_local)[0]
        if rpos.size:
            w[rpos] = sm.lookup(shard, ids[rpos])
        out.append(w.astype(np.int32))
    return out
