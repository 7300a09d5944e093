"""Iteration planner: strategy -> device-ready plans, on the host.

The planner is the host-side half of LeapGNN — the paper's system name; its
title says "HopGNN" and this repo keeps ``hopgnn`` as the strategy key.
It consumes a training-strategy name plus the mini-batch and emits
rectangular numpy arrays the device engine executes without dynamic
shapes:

  * ``model_centric`` — DGL baseline: one step, no redistribution; every
    shard fetches the (deduplicated) remote features of its whole subgraph.
  * ``hopgnn``        — §5.1 micrograph training: redistribution by home
    server, N rotating time steps, gradient accumulation. Pre-gathering
    (§5.2) and merging (§5.3) are orthogonal switches.
  * ``lo``            — locality-optimized baseline (§7.9): home-grouped,
    one step, no migration — fast but biased batches.

A copy of the reference's ``repro.core.strategies``: ``plan_iteration``
(training, resident or streamed from a tiered FeatureStore) and
``plan_inference`` (serving) give plans bitwise equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import Executor
from typing import Literal, Optional, Sequence

import numpy as np

from repro_torch.core.micrograph import (AssignmentMatrix, hopgnn_assignment,
                                         lo_assignment,
                                         model_centric_assignment)
from repro_torch.core.pregather import (GatherPlan, PlanOverflow,
                                        build_gather_plan,
                                        split_local_touched,
                                        stream_workspace_indices,
                                        workspace_indices)
from repro_torch.graph.sampler import TreeBlock, sample_tree_block
from repro_torch.graph.structs import CSRGraph
from repro_torch.obs import trace as _obs_trace

Strategy = Literal["model_centric", "hopgnn", "lo"]


def _pmap(executor: Optional[Executor], fn, items: list,
          label: Optional[str] = None) -> list:
    """Map ``fn`` over ``items``, fanning out on ``executor`` when given.

    The planner's per-(shard, step) work is numpy-heavy (sampling, dedup,
    searchsorted translation) and releases the GIL, so a small thread pool
    gives real multi-core planning without pickling graph structures.
    With ``label`` and tracing enabled, each item is recorded as a span on
    whichever thread runs it — the planner-pool fan-out shows up as its
    own Perfetto lanes."""
    if label is not None and _obs_trace.is_enabled():
        inner = fn

        def fn(item, _inner=inner, _label=label):  # noqa: F811
            with _obs_trace.span(_label):
                return _inner(item)
    if executor is None or len(items) <= 1:
        return [fn(x) for x in items]
    return list(executor.map(fn, items))


@dataclasses.dataclass
class IterationPlan:
    """Device-ready arrays (all stacked over the shard axis 0) + accounting.

    Workspace layout on shard s: rows [0, local_rows) are the local feature
    shard; rows [local_rows + p*r_max + j] hold the j-th pre-gathered row
    from peer p. In per-step mode the remote region is rebuilt each step
    from ``step_req``.
    """

    # --- static config ---
    num_shards: int
    num_steps: int
    fanout: int
    num_layers: int
    pregather: bool
    local_rows: int
    r_max: int
    batch_pad: int           # padded roots per (shard, step)
    global_batch: int        # true total roots (loss normalization)

    # --- device arrays ---
    req: np.ndarray                      # (N, P, r_max) int32 (pregather) or
    step_req: Optional[np.ndarray]       # (N, T, P, r_max) int32 (per-step)
    hop_idx: list                        # [h]: (N, T, batch_pad * f**h) int32
    labels: np.ndarray                   # (N, T, batch_pad) int32
    weights: np.ndarray                  # (N, T, batch_pad) f32

    # --- host accounting (exact, unpadded) ---
    remote_rows_exact: int               # deduped remote feature rows fetched
    remote_rows_nodedup: int             # without §5.2 dedup (per-step uniq)
    total_rows: int                      # all feature rows touched (tree, dup)
    unique_rows: int                     # deduped rows touched
    step_unique_rows: int                # Σ per-(shard,step) unique rows
    true_counts: np.ndarray              # (T, N) roots per (step, shard)
    assignment: AssignmentMatrix

    # --- remote-feature cache (repro_torch.cache; defaults = cache off) ---
    c_max: int = 0                       # cached workspace region height
    cache_version: int = -1              # CacheStore version planned against
    cache_hit_rows: int = 0              # deduped remote rows served locally
    remote_ids: Optional[list] = None    # per-shard deduped remote ids the
    #                                      iteration requested (hits+misses)
    #                                      — what a trailing LFU observes

    # --- async pipeline (repro_torch.train.pipeline; None = not
    # committed) ---
    committed: Optional[dict] = None     # {"dev": device-resident
    #                                      device_args tree, "denom": f32
    #                                      scalar, "event": the upload's
    #                                      CUDA event or None} uploaded
    #                                      ahead of time by the plan
    #                                      prefetch thread; the engine's
    #                                      prepare fast path uses it verbatim

    # --- streamed feature path (repro_torch.features; tiered store) ---
    streamed: bool = False               # features ride in the plan, not in
    #                                      a device-resident table
    l_max: int = 0                       # compacted touched-local region
    #                                      height (budgeted like r_max)
    feat_local: Optional[np.ndarray] = None   # (N, l_max, d) touched local
    feat_fetch: Optional[np.ndarray] = None   # (N, P, r_max, d) miss rows,
    #                                      gathered host-side through the
    #                                      store's tier chain
    tier_stats: Optional[dict] = None    # per-tier rows/bytes this plan's
    #                                      host gathers resolved through

    def miss_rate(self) -> float:
        """Remote fraction of unique feature rows (paper Fig. 14)."""
        return self.remote_rows_exact / max(self.unique_rows, 1)

    def cache_hit_rate(self) -> float:
        """Of the deduped remote rows this iteration needs, the fraction
        served from the resident cache instead of the fabric."""
        denom = self.cache_hit_rows + self.remote_rows_exact
        return self.cache_hit_rows / max(denom, 1)

    def miss_rate_per_request(self) -> float:
        """Fig. 14's cache view: of all feature *requests* (one per unique
        vertex per (shard, step)), the fraction served remotely, without
        §5.2's cross-step dedup."""
        return self.remote_rows_nodedup / max(self.step_unique_rows, 1)

    def device_args(self):
        """The tree of numpy arrays handed to the device engine."""
        if self.streamed:
            # features travel WITH the plan; no req (nothing to exchange —
            # the host gather through the tier chain already happened)
            return dict(feat_local=self.feat_local,
                        feat_fetch=self.feat_fetch,
                        hop_idx=list(self.hop_idx), labels=self.labels,
                        weights=self.weights)
        return dict(req=self.req, step_req=self.step_req,
                    hop_idx=list(self.hop_idx), labels=self.labels,
                    weights=self.weights)


def _pad_tree_block(blk: TreeBlock, batch_pad: int,
                    pad_vertex: int) -> TreeBlock:
    """Pad a sampled block to ``batch_pad`` roots with a constant vertex at
    every position of every padded subtree (rows computed and discarded).
    True-root hops are shared, not copied."""
    k = blk.batch_size
    if k == batch_pad:
        return blk
    f = blk.fanout
    hops = [np.concatenate(
        [ids, np.full((batch_pad - k) * f ** h, pad_vertex, ids.dtype
                      if ids.size else np.int64)])
        for h, ids in enumerate(blk.hops)]
    return TreeBlock(hops=hops, fanout=f)


def _assignment_for(strategy: Strategy, roots_per_model, part,
                    override: Optional[AssignmentMatrix]) -> AssignmentMatrix:
    if override is not None:
        return override
    if strategy == "model_centric":
        return model_centric_assignment(roots_per_model)
    if strategy == "hopgnn":
        return hopgnn_assignment(roots_per_model, part)
    if strategy == "lo":
        return lo_assignment(roots_per_model, part)
    raise ValueError(f"unknown strategy {strategy!r}")


def plan_iteration(graph: CSRGraph,
                   labels: np.ndarray,
                   part: np.ndarray,
                   owner: np.ndarray,
                   local_idx: np.ndarray,
                   local_rows: int,
                   roots_per_model: Sequence[np.ndarray],
                   num_layers: int,
                   fanout: int,
                   strategy: Strategy = "hopgnn",
                   pregather: bool = True,
                   assignment: Optional[AssignmentMatrix] = None,
                   rng: Optional[np.random.Generator] = None,
                   sample_seed: Optional[int] = None,
                   batch_pad: Optional[int] = None,
                   r_max: Optional[int] = None,
                   c_max: Optional[int] = None,
                   cache_index=None,
                   executor: Optional[Executor] = None,
                   feature_store=None,
                   l_max: Optional[int] = None) -> IterationPlan:
    """Compile one training iteration into an IterationPlan.

    ``sample_seed`` switches to stateless per-root-deterministic sampling:
    the tree below each root depends only on (root, seed), so two plans with
    the same roots and seed — regardless of strategy — train *identical*
    micrographs. This is the gradient-parity (accuracy fidelity) invariant.

    ``executor``: optional thread pool the per-(shard, step) sampling and
    per-shard index translation fan out on (the Trainer passes its planning
    pool). Requires ``sample_seed`` for the sampling fan-out — a shared
    stateful ``rng`` is not thread-safe, so with ``rng`` sampling stays
    serial and only the translation parallelizes. Results are independent
    of the executor (same blocks, same arrays, deterministic order).

    ``cache_index``: resident remote-feature cache
    (repro_torch.cache.CacheIndex); needed remote ids split into cache hits
    (read from the device-resident cached region) and misses (shipped
    through the exchange). ``c_max`` is the shape *budget* for the cached
    region — the plan's actual cached height always equals the index's own
    padded ``c_max``; a budget smaller than that raises
    :class:`PlanOverflow` so the ShapeBudget can re-bucket explicitly (the
    compile-once contract extended to cache growth).

    ``feature_store``: a repro_torch.features.FeatureStore. A *resident*
    store is equivalent to the classic dense table and planning is
    unchanged. A *tiered* store switches the plan to **streamed** mode: no
    device table exists, so the iteration's needed feature rows are
    host-gathered here through the store's tier chain (hot tier → mmap
    disk) into per-plan blocks — a compacted ``(N, l_max, d)``
    touched-local region plus the ``(N, P, r_max, d)`` miss rows — and the
    workspace indices target ``[local_compact | cached | fetched]``.
    ``l_max`` budgets the compacted region exactly like ``r_max`` budgets
    fetches (PlanOverflow on overflow). Streamed mode requires
    ``pregather=True`` (per-step exchanges presume a device-resident table
    to serve from).
    """
    if cache_index is not None and c_max is not None \
            and cache_index.c_max > c_max:
        raise PlanOverflow("c_max", int(cache_index.c_max), int(c_max))
    streamed = feature_store is not None and not feature_store.resident
    if streamed and not pregather:
        raise ValueError("streamed feature plans (tiered FeatureStore) "
                         "require pregather=True — the per-step exchange "
                         "serves from a device-resident table")
    if sample_seed is None:
        rng = rng or np.random.default_rng(0)
    n = len(roots_per_model)
    if strategy == "lo":
        # LO samples only within the local partition (that *is* the bias
        # the paper measures in §7.9): drop cross-partition edges so every
        # sampled neighbor — hence every feature — is local.
        from repro_torch.graph.partition import drop_cross_edges
        graph = drop_cross_edges(graph, part)
    amat = _assignment_for(strategy, [np.asarray(r, np.int64)
                                      for r in roots_per_model], part, assignment)
    T = amat.num_steps

    # Padding roots must add no phantom remote traffic: each (shard, step)
    # block is sampled over its *true* roots only and then padded with a
    # constant local vertex at every tree position (not with the pad
    # vertex's real sampled neighborhood, which could be remote). The
    # stateless sampler makes a root's subtree independent of its batch
    # position, so true-root trees are unchanged; padded positions carry
    # weight 0 and never touch the loss. This also makes planned remote
    # requests a pure function of (roots, seed) — what the repro_torch.cache
    # epoch prefetcher predicts.
    pad_vertex = np.zeros(n, np.int64)
    for s in range(n):
        loc = np.nonzero(owner == s)[0]
        pad_vertex[s] = loc[0] if loc.size else 0

    counts = amat.root_counts()                      # (T, N)
    if batch_pad is None:
        batch_pad = max(1, int(counts.max()))
    if counts.max() > batch_pad:
        raise PlanOverflow("batch_pad", int(counts.max()), int(batch_pad))

    # ---- sample one TreeBlock per (shard, step), pad with local rows ----
    lab_arr = np.zeros((n, T, batch_pad), np.int32)
    w_arr = np.zeros((n, T, batch_pad), np.float32)
    jobs = []                                   # (s, t, true_roots, k)
    for s in range(n):
        for t in range(T):
            roots = amat.roots_at(s, t)
            k = roots.size
            if k:
                lab_arr[s, t, :k] = labels[roots]
                w_arr[s, t, :k] = 1.0
            jobs.append((s, t, roots, k))

    sample_exec = executor if sample_seed is not None else None
    blks = _pmap(sample_exec,
                 lambda j: sample_tree_block(graph, j[2], num_layers, fanout,
                                             rng=rng, seed=sample_seed),
                 jobs, label="plan.sample")
    blocks: list[list[TreeBlock]] = [[None] * T for _ in range(n)]  # [s][t]
    true_root_blocks: list[TreeBlock] = []      # unpadded, for accounting
    for (s, t, _, k), blk in zip(jobs, blks):
        blocks[s][t] = _pad_tree_block(blk, batch_pad, pad_vertex[s])
        if k:
            true_root_blocks.append(blk)

    # ---- gather plans ----
    def shard_needed(s: int, ts: Sequence[int]) -> np.ndarray:
        ids = [blocks[s][t].all_ids() for t in ts]
        return np.concatenate(ids) if ids else np.zeros(0, np.int64)

    hop_sizes = [batch_pad * fanout ** h for h in range(num_layers + 1)]
    hop_idx = [np.zeros((n, T, sz), np.int32) for sz in hop_sizes]

    if pregather:
        needed = [shard_needed(s, range(T)) for s in range(n)]
        if streamed:
            local_ids, l_max_eff = split_local_touched(needed, owner, l_max)
            plan = build_gather_plan(needed, owner, local_idx, n, l_max_eff,
                                     r_max, cache=cache_index)
        else:
            local_ids, l_max_eff = None, 0
            plan = build_gather_plan(needed, owner, local_idx, n, local_rows,
                                     r_max, cache=cache_index)
        req, step_req = plan.req, None
        r_max_eff = plan.r_max
        c_max_eff = plan.c_max

        def translate_shard(s: int) -> None:
            # writes land in disjoint (s, t) slices — thread-safe fan-out
            for t in range(T):
                widx = (stream_workspace_indices(blocks[s][t].hops, s,
                                                 owner, local_ids[s], plan)
                        if streamed else
                        workspace_indices(blocks[s][t].hops, s, owner,
                                          local_idx, plan))
                for h in range(num_layers + 1):
                    hop_idx[h][s, t] = widx[h]

        _pmap(executor, translate_shard, list(range(n)),
              label="plan.translate")
        remote_exact = plan.remote_rows_exact()
        cache_hit_rows = plan.cache_hit_rows()
        # only trailing-LFU observation consumes remote_ids; don't tax the
        # cache-off planning hot path with the copies
        remote_ids = ([plan.slot_map.shard_ids(s).copy() for s in range(n)]
                      if cache_index is not None else None)
        if streamed:
            feat_local, feat_fetch, tier_stats = _stream_features(
                feature_store, plan, local_ids, local_idx, l_max_eff, n)
        else:
            feat_local = feat_fetch = tier_stats = None
    else:
        # per-step exchange: dedup within a step only — redundant fetches
        # across steps remain (that is exactly what §5.2 eliminates). A
        # resident cache still dedups across steps implicitly: a cached
        # vertex is a hit at *every* step that touches it.
        step_plans = _pmap(
            executor,
            lambda t: build_gather_plan([shard_needed(s, [t])
                                         for s in range(n)],
                                        owner, local_idx, n, local_rows,
                                        r_max, cache=cache_index),
            list(range(T)), label="plan.step_gather")
        r_max_eff = r_max or max(p.r_max for p in step_plans)
        c_max_eff = step_plans[0].c_max if step_plans else 0
        if any(p.req_count.max() > r_max_eff for p in step_plans):
            raise PlanOverflow(
                "r_max", int(max(p.req_count.max() for p in step_plans)),
                int(r_max_eff))
        step_req = np.zeros((n, T, n, r_max_eff), np.int32)

        def translate_step(t: int) -> None:
            p = step_plans[t]
            if p.r_max != r_max_eff:   # rebuild with the common r_max
                p = build_gather_plan([shard_needed(s, [t]) for s in range(n)],
                                      owner, local_idx, n, local_rows,
                                      r_max_eff, cache=cache_index)
                step_plans[t] = p
            step_req[:, t] = p.req
            for s in range(n):
                widx = workspace_indices(blocks[s][t].hops, s, owner,
                                         local_idx, p)
                for h in range(num_layers + 1):
                    hop_idx[h][s, t] = widx[h]

        _pmap(executor, translate_step, list(range(T)),
              label="plan.translate")
        req = np.zeros((n, n, r_max_eff), np.int32)  # unused in per-step mode
        l_max_eff = 0
        feat_local = feat_fetch = tier_stats = None
        remote_exact = sum(p.remote_rows_exact() for p in step_plans)
        cache_hit_rows = sum(p.cache_hit_rows() for p in step_plans)
        remote_ids = ([
            np.unique(np.concatenate(
                [p.slot_map.shard_ids(s) for p in step_plans]
                or [np.zeros(0, np.int64)]))
            for s in range(n)] if cache_index is not None else None)

    # ---- accounting over true (unpadded) roots ----
    total_rows = sum(b.num_feature_rows() for b in true_root_blocks)
    uniq_all: list[np.ndarray] = []
    remote_nodedup = 0
    step_unique = 0
    for s in range(n):
        per_step_ids = []
        for t in range(T):
            roots = amat.roots_at(s, t)
            if roots.size == 0:
                continue
            ids = blocks[s][t].select(np.arange(roots.size)).all_ids()
            per_step_ids.append(ids)
        if per_step_ids:
            allids = np.concatenate(per_step_ids)
            uniq_all.append(np.unique(allids))
            for ids in per_step_ids:
                u = np.unique(ids)
                step_unique += u.size
                remote_nodedup += int((owner[u] != s).sum())
    unique_rows = int(sum(u.size for u in uniq_all))

    return IterationPlan(
        num_shards=n, num_steps=T, fanout=fanout, num_layers=num_layers,
        pregather=pregather, local_rows=local_rows, r_max=r_max_eff,
        batch_pad=batch_pad,
        global_batch=int(sum(np.asarray(r).size for r in roots_per_model)),
        req=req, step_req=step_req, hop_idx=hop_idx, labels=lab_arr,
        weights=w_arr,
        remote_rows_exact=remote_exact, remote_rows_nodedup=remote_nodedup,
        total_rows=total_rows, unique_rows=unique_rows,
        step_unique_rows=step_unique,
        true_counts=counts, assignment=amat,
        c_max=c_max_eff,
        cache_version=(cache_index.version if cache_index is not None
                       else -1),
        cache_hit_rows=cache_hit_rows, remote_ids=remote_ids,
        streamed=streamed, l_max=l_max_eff,
        feat_local=feat_local, feat_fetch=feat_fetch, tier_stats=tier_stats)


def _stream_features(store, plan: GatherPlan, local_ids: list, local_idx,
                     l_max: int, n: int):
    """Host-gather a streamed plan's feature blocks through the store's
    tier chain. Padded rows stay zero (padded slots are never read — the
    same contract as padded request slots in the exchange path)."""
    d = store.feature_dim
    snap = store.stats.snapshot()
    feat_local = np.zeros((n, l_max, d), store.dtype)
    for s in range(n):
        k = int(local_ids[s].size)
        if k:
            feat_local[s, :k] = store.gather(s, local_idx[local_ids[s]])
    feat_fetch = np.zeros((n, n, plan.r_max, d), store.dtype)
    cnt = plan.req_count
    for p in range(n):
        segs = [(s, int(cnt[s, p])) for s in range(n) if cnt[s, p]]
        if not segs:
            continue
        # one tier-chain gather per OWNING shard: all requesting shards'
        # misses from peer p are batched (better hot-tier locality, one
        # counted gather)
        cat = np.concatenate([plan.req[s, p, :c] for s, c in segs]
                             ).astype(np.int64)
        rows = store.gather(p, cat)
        off = 0
        for s, c in segs:
            feat_fetch[s, p, :c] = rows[off:off + c]
            off += c
    delta = store.stats.delta(snap)
    rb = store.row_bytes
    tier_stats = dict(tier1_rows=int(delta.t1_rows),
                      tier2_rows=int(delta.t2_rows),
                      tier1_bytes=int(delta.t1_rows) * rb,
                      tier2_bytes=int(delta.t2_rows) * rb,
                      upload_bytes=int(feat_local.nbytes
                                       + feat_fetch.nbytes))
    return feat_local, feat_fetch, tier_stats


@dataclasses.dataclass
class InferencePlan:
    """One serving micro-batch, planned host-side for the compiled forward.

    The workspace layout is ``[cached | fetched]``: the server's hot
    feature rows (a repro_torch.cache CacheStore, height ``c_max``) followed by
    the batch's remaining unique rows, host-gathered through the feature
    store's tier chain. ``hop_idx[h]`` indexes that workspace for every
    tree position of hop h. The fetched-region *height* is not fixed here —
    positions only ever point below ``c_max + fetch_ids.size``, so the
    server pads the gather buffer to its ShapeBudget rung (``u_max``)
    without re-planning (unlike training, there is no exchange array whose
    shape the planner must commit to).
    """

    nodes: np.ndarray            # (k,) true requested vertices, caller order
    batch_pad: int               # padded root count (pow2 serve rung)
    fanout: int
    c_max: int                   # cached-region height the plan indexes into
    cache_version: int           # CacheIndex.version guarded at dispatch
    hop_idx: list                # [h]: (batch_pad * fanout**h,) int32
    fetch_ids: np.ndarray        # sorted unique global ids to host-gather
    cache_hit_rows: int          # unique rows served from the cached region
    touched: np.ndarray          # sorted unique ids of the TRUE trees
    touched_counts: np.ndarray   # aligned multiplicities (admission signal)

    @property
    def num_layers(self) -> int:
        return len(self.hop_idx) - 1


def plan_inference(graph: CSRGraph, nodes: np.ndarray, num_layers: int,
                   fanout: int, *, sample_seed: int,
                   batch_pad: Optional[int] = None,
                   cache_index=None,
                   pad_vertex: int = 0) -> InferencePlan:
    """Plan one serving micro-batch: sample, dedup, translate.

    The stateless sampler makes each root's tree a pure function of
    ``(root, sample_seed)`` — independent of batch composition — and the
    forward is row-wise per root, so a served vertex's logits do not depend
    on how the micro-batcher packed it (up to the matmul library's choice
    of algorithm per shape; see PERF.md). The plan itself is bit-identical
    to the reference planner's. Padding roots (``pad_vertex`` trees filling
    the rung) are computed and discarded.

    ``cache_index`` splits unique ids into hot rows (already device-resident
    in the serve cache, slot < c_max) and ``fetch_ids`` misses; indices are
    translated against the ``[cached | fetched]`` layout in one searchsorted
    pass — the same SlotMap idiom as the training GatherPlan.
    """
    nodes = np.asarray(nodes, np.int64).ravel()
    k = int(nodes.size)
    if batch_pad is None:
        batch_pad = max(k, 1)
    if k > batch_pad:
        raise PlanOverflow("batch_pad", k, int(batch_pad))
    blk = sample_tree_block(graph, nodes, num_layers, fanout,
                            seed=sample_seed)
    touched, touched_counts = np.unique(blk.all_ids(), return_counts=True)
    blk = _pad_tree_block(blk, int(batch_pad), int(pad_vertex))
    uniq = blk.unique_ids()

    if cache_index is not None:
        hit, slots = cache_index.hit_split(0, uniq)
        c_max = int(cache_index.c_max)
        version = int(cache_index.version)
    else:
        hit = np.zeros(uniq.size, bool)
        slots = np.zeros(uniq.size, np.int64)
        c_max, version = 0, 0
    miss = ~hit
    fetch_ids = uniq[miss]
    # workspace position of uniq[i]: its cache slot on a hit, else c_max +
    # rank among the misses (fetched rows are uploaded in sorted-id order)
    wspos = np.where(hit, slots, c_max + np.cumsum(miss) - 1)
    hop_idx = [wspos[np.searchsorted(uniq, ids)].astype(np.int32)
               for ids in blk.hops]
    return InferencePlan(nodes=nodes, batch_pad=int(batch_pad),
                         fanout=int(fanout), c_max=c_max,
                         cache_version=version, hop_idx=hop_idx,
                         fetch_ids=fetch_ids,
                         cache_hit_rows=int(hit.sum()),
                         touched=touched, touched_counts=touched_counts)
