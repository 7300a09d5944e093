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
A training plan counts the paper's Fig. 14 rows when one of those counts
is first read, not while it is built: training reads none of them. Given
the graph on a device (:class:`DeviceTrees`), a plan draws its trees there
and, where it pregathers without a cache or a streamed store, dedups and
translates them there as well (:mod:`repro_torch.kernels.plan_dedup`).
"""
from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import Executor
from typing import Callable, Literal, Optional, Sequence

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
from repro_torch.kernels.plan_dedup import DevicePartition
from repro_torch.kernels.sample_tree import DeviceCSR
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

    # --- host accounting (exact, unpadded; unique_rows, step_unique_rows
    # and remote_rows_nodedup are counted from _true_hops() when first
    # read) ---
    remote_rows_exact: int               # deduped remote feature rows fetched
    total_rows: int                      # all feature rows touched (tree, dup)
    true_counts: np.ndarray              # (T, N) roots per (step, shard)
    assignment: AssignmentMatrix
    _true_hops: Callable[[], list] = dataclasses.field(repr=False,
                                                       compare=False)
    #                                      () -> [s][j][h]: true-root hop
    #                                      prefixes
    _owner: np.ndarray = dataclasses.field(repr=False, compare=False)

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

    @functools.cached_property
    def _row_counts(self) -> tuple[int, int, int]:
        return _count_rows(self._true_hops(), self._owner)

    @property
    def unique_rows(self) -> int:
        """Deduped rows touched."""
        return self._row_counts[0]

    @property
    def step_unique_rows(self) -> int:
        """Σ per-(shard, step) unique rows."""
        return self._row_counts[1]

    @property
    def remote_rows_nodedup(self) -> int:
        """Remote rows without §5.2 dedup (per-step unique)."""
        return self._row_counts[2]

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


def pad_vertices(owner: np.ndarray, n: int) -> np.ndarray:
    """Each shard's pad vertex: the first vertex it owns (0 for a shard
    that owns none)."""
    pad_vertex = np.zeros(n, np.int64)
    for s in range(n):
        loc = np.nonzero(owner == s)[0]
        pad_vertex[s] = loc[0] if loc.size else 0
    return pad_vertex


@dataclasses.dataclass(frozen=True)
class DeviceTrees:
    """What :func:`plan_iteration` needs to draw a plan's trees on a
    device, and to dedup and translate them there: the graph's CSR and the
    partition's rows (``owner``, ``local_idx``, each shard's pad vertex),
    functions of the graph and the partition alone, so built once
    (:meth:`build`) rather than on every plan."""

    csr: DeviceCSR
    part: DevicePartition

    @property
    def pad_vertex(self) -> np.ndarray:
        return self.part.pad_vertex_host

    @classmethod
    def build(cls, graph: CSRGraph, owner: np.ndarray, local_idx: np.ndarray,
              num_shards: int, device) -> "DeviceTrees":
        csr = DeviceCSR.from_graph(graph, device)
        return cls(csr, _device_partition(csr, owner, local_idx, num_shards))

    def for_partition(self, owner: np.ndarray, local_idx: np.ndarray,
                      num_shards: int) -> "DeviceTrees":
        """The same CSR beside another partition's rows (a new world)."""
        return DeviceTrees(self.csr, _device_partition(self.csr, owner,
                                                       local_idx, num_shards))


def _device_partition(csr: DeviceCSR, owner: np.ndarray,
                      local_idx: np.ndarray,
                      num_shards: int) -> DevicePartition:
    """The partition's rows beside ``csr``, on its device and stream."""
    if np.asarray(owner).shape != (csr.num_vertices,):
        raise ValueError(f"DeviceTrees: owner of shape "
                         f"{np.asarray(owner).shape} for a graph of "
                         f"{csr.num_vertices} vertices")
    return DevicePartition(owner, local_idx, pad_vertices(owner, num_shards),
                           csr.indptr.device, csr.stream)


def _slice_jobs(hops: list, jobs: list, fanout: int) -> list:
    """One TreeBlock per job out of the hop-wise expansion of the jobs'
    concatenated roots: job j's trees are the slice [off_j * f**h,
    (off_j + k_j) * f**h) of hop h."""
    blks, off = [], 0
    for *_, k in jobs:
        blks.append(TreeBlock(hops=[ids[off * fanout ** h:
                                        (off + k) * fanout ** h]
                                    for h, ids in enumerate(hops)],
                              fanout=fanout))
        off += k
    return blks


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
                   l_max: Optional[int] = None,
                   device_trees: Optional[DeviceTrees] = None
                   ) -> IterationPlan:
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

    ``device_trees``: the graph's CSR and the partition's rows on a device
    (:class:`DeviceTrees`, built from this ``graph``, ``owner`` and
    ``local_idx``). With a ``sample_seed``, and a strategy other than
    ``lo`` (which samples a graph rebuilt on every call), the trees of all
    (shard, step) jobs are drawn there in one expansion of their
    concatenated roots, hop by hop (``plan.sample`` tagged
    ``path="device"``). Where the plan also pregathers, with no
    ``cache_index`` and no streamed store, the trees stay there: the §5.2
    dedup and the translation run on the device too (``plan.dedup`` and
    ``plan.translate`` tagged ``path="device"``), and only the finished
    ``req`` and ``hop_idx`` come back. Otherwise the trees come back and
    the host dedups and translates. Either way the plan is bitwise the host
    path's. Without them the host samples (``path="host"``).

    The plan keeps its trees' true-root prefixes (views, not copies; on the
    device path the trees, copied to the host on first read) and counts the
    Fig. 14 rows from them when first read, not here.
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
    span = _obs_trace.span
    on_device = (device_trees is not None and sample_seed is not None
                 and strategy != "lo")
    # the dedup and translation follow the trees onto the device where the
    # plan needs neither the cache's split nor the streamed store's
    # compaction: every other plan dedups and translates on the host
    device_plan = (on_device and pregather and cache_index is None
                   and not streamed)
    if on_device and device_trees.pad_vertex.shape != (n,):
        raise ValueError(f"device_trees holds pad vertices of "
                         f"{device_trees.pad_vertex.shape[0]} shards, the "
                         f"plan has {n}")
    # ---- sample one TreeBlock per (shard, step), pad with local rows ----
    with span("plan.sample", path="device" if on_device else "host"):
        if strategy == "lo":
            # LO samples only within the local partition (that *is* the
            # bias the paper measures in §7.9): drop cross-partition edges
            # so every sampled neighbor — hence every feature — is local.
            from repro_torch.graph.partition import drop_cross_edges
            graph = drop_cross_edges(graph, part)
        amat = _assignment_for(strategy, [np.asarray(r, np.int64)
                                          for r in roots_per_model], part,
                               assignment)
        T = amat.num_steps

        # Padding roots must add no phantom remote traffic: each (shard,
        # step) block is sampled over its *true* roots only and then padded
        # with a constant local vertex at every tree position (not with the
        # pad vertex's real sampled neighborhood, which could be remote).
        # The stateless sampler makes a root's subtree independent of its
        # batch position, so true-root trees are unchanged; padded positions
        # carry weight 0 and never touch the loss. This also makes planned
        # remote requests a pure function of (roots, seed) — what the
        # repro_torch.cache epoch prefetcher predicts.
        pad_vertex = (device_trees.pad_vertex if on_device
                      else pad_vertices(owner, n))

        counts = amat.root_counts()                  # (T, N)
        if batch_pad is None:
            batch_pad = max(1, int(counts.max()))
        if counts.max() > batch_pad:
            raise PlanOverflow("batch_pad", int(counts.max()), int(batch_pad))

        lab_arr = np.zeros((n, T, batch_pad), np.int32)
        w_arr = np.zeros((n, T, batch_pad), np.float32)
        jobs = []                               # (s, t, true_roots, k)
        for s in range(n):
            for t in range(T):
                roots = amat.roots_at(s, t)
                k = roots.size
                if k:
                    lab_arr[s, t, :k] = labels[roots]
                    w_arr[s, t, :k] = 1.0
                jobs.append((s, t, roots, k))

        # the hash sees only (vertex, slot, hop, seed), so expanding the
        # jobs' concatenated roots gives each job's trees as slices
        if device_plan:
            trees = device_trees.csr.draw_trees(
                np.concatenate([j[2] for j in jobs]), num_layers, fanout,
                sample_seed)
        elif on_device:
            blks = _slice_jobs(device_trees.csr.sample_trees(
                np.concatenate([j[2] for j in jobs]), num_layers, fanout,
                sample_seed), jobs, fanout)
        else:
            sample_exec = executor if sample_seed is not None else None
            blks = _pmap(sample_exec,
                         lambda j: sample_tree_block(graph, j[2], num_layers,
                                                     fanout, rng=rng,
                                                     seed=sample_seed),
                         jobs, label="plan.sample.job")
        if not device_plan:
            blocks: list[list[TreeBlock]] = [[None] * T for _ in range(n)]
            for (s, t, _, k), blk in zip(jobs, blks):
                blocks[s][t] = _pad_tree_block(blk, batch_pad, pad_vertex[s])

    # ---- gather plans ----
    def shard_needed(s: int, ts: Sequence[int]) -> np.ndarray:
        ids = [blocks[s][t].all_ids() for t in ts]
        return np.concatenate(ids) if ids else np.zeros(0, np.int64)

    hop_sizes = [batch_pad * fanout ** h for h in range(num_layers + 1)]
    hop_idx = (None if device_plan else
               [np.zeros((n, T, sz), np.int32) for sz in hop_sizes])

    if device_plan:
        req, hop_idx, r_max_eff, remote_exact = _index_on_device(
            device_trees.part, trees, jobs, T, batch_pad, num_layers, fanout,
            local_rows, r_max)
        step_req = None
        c_max_eff = cache_hit_rows = l_max_eff = 0
        remote_ids = feat_local = feat_fetch = tier_stats = None
    elif pregather:
        with span("plan.dedup") as dedup_span:
            needed = [shard_needed(s, range(T)) for s in range(n)]
            if streamed:
                local_ids, l_max_eff = split_local_touched(needed, owner,
                                                           l_max)
                plan = build_gather_plan(needed, owner, local_idx, n,
                                         l_max_eff, r_max, cache=cache_index)
            else:
                local_ids, l_max_eff = None, 0
                plan = build_gather_plan(needed, owner, local_idx, n,
                                         local_rows, r_max, cache=cache_index)
            dedup_span.tag(path=plan.dedup)
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

        with span("plan.translate"):
            _pmap(executor, translate_shard, list(range(n)),
                  label="plan.translate.job")
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
        with span("plan.dedup") as dedup_span:
            step_plans = _pmap(
                executor,
                lambda t: build_gather_plan([shard_needed(s, [t])
                                             for s in range(n)],
                                            owner, local_idx, n, local_rows,
                                            r_max, cache=cache_index),
                list(range(T)), label="plan.dedup.job")
            # every step's ids are padded to one size, so one path
            dedup_span.tag(path="+".join(sorted({p.dedup
                                                  for p in step_plans})))
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

        with span("plan.translate"):
            _pmap(executor, translate_step, list(range(T)),
                  label="plan.translate.job")
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
    # A true root's tree holds fanout**h positions at hop h, and padding
    # follows the true roots, so the true ids of (s, t) are prefixes of its
    # padded hops: views, kept for the counts the plan computes when read.
    total_rows = (sum(k for *_, k in jobs)
                  * sum(fanout ** h for h in range(num_layers + 1)))
    if device_plan:
        # the trees stay on the device until a count is first read
        read_true_hops = functools.partial(_true_hops_from_device, trees,
                                           device_trees.csr, jobs, n,
                                           num_layers, fanout)
    else:
        true_hops: list[list[list[np.ndarray]]] = [[] for _ in range(n)]
        for s, t, _, k in jobs:
            if k:
                true_hops[s].append([ids[:k * fanout ** h] for h, ids
                                     in enumerate(blocks[s][t].hops)])

        def read_true_hops():
            return true_hops

    return IterationPlan(
        num_shards=n, num_steps=T, fanout=fanout, num_layers=num_layers,
        pregather=pregather, local_rows=local_rows, r_max=r_max_eff,
        batch_pad=batch_pad,
        global_batch=int(sum(np.asarray(r).size for r in roots_per_model)),
        req=req, step_req=step_req, hop_idx=hop_idx, labels=lab_arr,
        weights=w_arr,
        remote_rows_exact=remote_exact, total_rows=total_rows,
        true_counts=counts, assignment=amat,
        _true_hops=read_true_hops, _owner=owner,
        c_max=c_max_eff,
        cache_version=(cache_index.version if cache_index is not None
                       else -1),
        cache_hit_rows=cache_hit_rows, remote_ids=remote_ids,
        streamed=streamed, l_max=l_max_eff,
        feat_local=feat_local, feat_fetch=feat_fetch, tier_stats=tier_stats)


def _index_on_device(part: DevicePartition, trees, jobs: list, steps: int,
                     batch_pad: int, num_layers: int, fanout: int,
                     local_rows: int, r_max: Optional[int]):
    """``(req, hop_idx, r_max, remote_rows_exact)`` of a pregathered plan
    whose trees ``trees`` were drawn on the device (``jobs``' trees one after
    another, hop by hop): the §5.2 dedup and the workspace translation on
    the device, bitwise :func:`build_gather_plan` and
    :func:`workspace_indices` without a cache. The ``r_max`` budget is
    checked against the counts before any slot is laid out."""
    span = _obs_trace.span
    with span("plan.dedup", path="device"):
        dd = part.count(trees, np.array([k for *_, k in jobs], np.int64),
                        steps, num_layers, fanout, batch_pad)
        need = int(dd.req_count.max())
        if r_max is None:
            r_max = max(1, need)
        if need > r_max:
            raise PlanOverflow("r_max", need, int(r_max))
        part.scatter(dd, r_max, local_rows)
    with span("plan.translate", path="device"):
        req, hop_idx = part.translate(dd)
    return req, hop_idx, r_max, int(dd.req_count.sum())


def _true_hops_from_device(trees, csr: DeviceCSR, jobs: list, n: int,
                           num_layers: int, fanout: int) -> list:
    """The true-root hop prefixes ``[s][j][h]`` of trees drawn on the
    device by ``csr``, copied to the host."""
    flat = csr.to_host(trees)
    k = sum(j[3] for j in jobs)
    sizes = [k * fanout ** h for h in range(num_layers + 1)]
    ends = np.cumsum(sizes).tolist()
    hops = [flat[e - sz:e] for sz, e in zip(sizes, ends)]
    true_hops: list[list[list[np.ndarray]]] = [[] for _ in range(n)]
    for (s, _, _, k), blk in zip(jobs, _slice_jobs(hops, jobs, fanout)):
        if k:
            true_hops[s].append(blk.hops)
    return true_hops


def _count_rows(true_hops: list, owner: np.ndarray) -> tuple[int, int, int]:
    """``(unique_rows, step_unique_rows, remote_rows_nodedup)`` of
    ``true_hops[s]``, a list of one hop list per (s, t) that has true
    roots, by sorting: the distinct ids of each shard, the distinct ids of
    each (s, t), and those of the latter that shard s does not own."""
    unique = step_unique = remote = 0
    for s, steps in enumerate(true_hops):
        if not steps:
            continue
        per_step = [np.concatenate(hops) for hops in steps]
        unique += np.unique(np.concatenate(per_step)).size
        for ids in per_step:
            u = np.unique(ids)
            step_unique += u.size
            remote += int((owner[u] != s).sum())
    return unique, step_unique, remote


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
