"""Compile-once Trainer: the LeapGNN iteration hot path as one subsystem.

The port of ``repro.train.loop``:

* **Shape budget** — one :class:`~repro_torch.train.budget.ShapeBudget`
  per run quantizes ``batch_pad``/``r_max`` so every IterationPlan of a
  merge pattern shares device shapes and each engine callable sees one
  signature per bucket, not one per step (the engine's trace log).
* **Plan prefetch** — a background thread double-buffers plan *i+1* while
  the device executes plan *i*, and the plan under construction fans its
  per-(shard, step) sampling and per-shard translation out over a small
  planning pool (``planner_threads``; numpy releases the GIL). Results are
  independent of the pool. Per-epoch planning time and plan counts land in
  :class:`EpochStats`.
* **Merging** — a §5.3 :class:`MergingController` driven by steady-state
  time per epoch, excluding iterations on which the engine's trace log
  recorded a new signature.
* **Remote-feature cache** — an optional repro_torch.cache layer
  (``cache_policy="degree"|"lfu"``, ``cache_budget_bytes``): per-shard hot
  remote rows stay on the device, the planner splits needed ids into hits
  and misses, and the deterministic sampler lets next epoch's hot set be
  computed and the store refreshed off the critical path
  (``cache_prefetch``). The store is pre-sized to the budget's pow2 row
  bucket, so refreshes never change device shapes.
* **Async device pipeline** (repro_torch.train.pipeline; default ON) —
  the optimizer update is fused into the iteration call, losses stay on
  the device until the epoch boundary, and the prefetch thread commits
  plan i+1's upload on a side CUDA stream while plan i executes.
  ``pipeline=False`` is the per-iteration blocking loop; ``fused=False``
  additionally takes the grads-then-update path. The parameters and
  moments are updated in place, so the Trainer copies caller-supplied
  initial parameters once and always continues from its own.
* **Tiered features** (:mod:`repro_torch.features`) — every feature read
  goes through one ``FeatureStore``. A resident store is uploaded once as
  the device table; a tiered one (host hot tier over mmap disk shards)
  switches the Trainer to streamed mode: no device table, each plan
  carries its own feature blocks gathered through the tiers on the
  prefetch thread, and the next epoch's rows are promoted tier 2 → tier 1
  at the epoch boundary (the readahead forecast runs on the cache thread
  during the epoch before). Streamed training is bitwise the resident
  training.
* **Eval + checkpoint/resume** — epoch-boundary checkpoints of
  (params, optimizer state, merge pattern, budget state) in the
  reference's crash-atomic npz layout (:mod:`repro_torch.checkpoint`), and
  tree-block evaluation on features gathered back out of the sharded
  table.
* **Resilience** (:mod:`repro_torch.resilience`; default ON, as in the
  reference: ``resilience=None`` is the default policy) — an epoch-start
  snapshot (cloned tensors: the update runs in place), supervised
  background threads, the comm retry guard around every dispatch, the
  stall deadline on plan futures, a NaN/Inf guard on each synced loss
  window, and the degradation ladder (``uploader_off``,
  ``pipeline_to_sync``, ``cache_off``, and for a tiered store
  ``resident_gather``). Scheduled ``disk_corrupt`` faults are injected at
  the epoch boundary, before readahead, so the store's checksums catch
  and repair them. Every recovery replays the epoch
  deterministically, so an absorbed fault leaves losses and parameters
  bit-identical to the fault-free run.
* **Membership** (:mod:`repro_torch.membership`, on with the default
  policy) — plans are stamped with the world generation and refused when
  it moves; a peer-attributed comm timeout is probed, and a confirmed
  death recovers by ``rejoin`` (bit-identical resume from the shared
  checkpoint) or by elastic shrink (``redistribute``/``adopt``).

Entry points run on ``cuda`` unless ``device="cpu"`` is given. Not ported
yet: a device ``mesh``, which raises ``NotImplementedError`` naming ROADMAP
Queue 1 item 8.

Typical use::

    trainer = Trainer(graph=ds.graph, labels=ds.labels, part=part,
                      owner=owner, local_idx=local_idx, table=table,
                      cfg=cfg, optimizer=adamw(3e-3),
                      train_vertices=ds.train_vertices())
    stats = trainer.fit(epochs=3, iters_per_epoch=8, batch_per_model=16)
"""
from __future__ import annotations

import copy
import dataclasses
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as futures_wait
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core import distributed as engine
from repro_torch.core.merging import MergingController, fold_assignment
from repro_torch.core.micrograph import hopgnn_assignment
from repro_torch.core.strategies import IterationPlan, Strategy
from repro_torch.core.tree import tree_clone
from repro_torch.device import resolve_device
from repro_torch.features import FeatureStore
from repro_torch.graph.sampler import sample_tree_block
from repro_torch.membership import (MembershipView, PeerProbe,
                                    StaleGeneration, peer_of)
from repro_torch.models.gnn.models import GNNConfig, gnn_accuracy, init_gnn
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span as obs_span
from repro_torch.optim import Optimizer, adamw
from repro_torch.resilience import (BackgroundError,
                                    CheckpointRollbackExhausted,
                                    CommCounters, CommTimeout, NonFiniteLoss,
                                    ResiliencePolicy, StallError,
                                    ThreadSupervisor, resilient_call)
from repro_torch.resilience import faults as _rfaults
from repro_torch.resilience.faults import InjectedFault
from repro_torch.train.budget import ShapeBudget, next_bucket
from repro_torch.train.pipeline import (EpochRunResult, PlanUploader,
                                        run_pipelined_epoch, stack_committed)


@dataclasses.dataclass
class EpochStats:
    """Per-epoch record returned by :meth:`Trainer.fit`."""

    epoch: int
    loss: float                 # mean iteration loss
    time_s: float               # raw wall time (planning + first calls + exec)
    steady_time_s: float        # trace-free steady estimate (see fit())
    traces: int                 # new engine signatures during this epoch
    num_steps: int              # merge pattern in effect
    remote_rows: int            # Σ plan.remote_rows_exact
    acc: Optional[float] = None
    compile_free: bool = True   # False: every iteration traced, so
    #                             steady_time_s still holds first calls
    plan_time_s: float = 0.0    # host planning time (prefetch thread; it
    #                             overlaps device time)
    plans_built: int = 0        # plans constructed during this epoch
    # --- remote-feature cache (zeros when the cache is off) ---
    cache_hit_rows: int = 0     # Σ plan.cache_hit_rows (deduped hits)
    cache_hit_rate: float = 0.0  # hits / (hits + misses) over the epoch
    cache_bytes_saved: int = 0  # hit rows × row bytes
    cache_refresh_s: float = 0.0  # blocking refresh time at the epoch
    #                               boundary (prefetch overlap already taken)
    # --- async pipeline (see repro_torch.train.pipeline) ---
    pipelined: bool = False     # this epoch ran the non-blocking fused loop
    dispatch_s: float = 0.0     # host time inside dispatch calls (pipelined
    #                             mode only)
    # --- tiered feature store (zeros when resident) ---
    streamed: bool = False      # out-of-core mode: plans carry features
    tier1_rows: int = 0         # host hot-tier rows served to plan gathers
    tier2_rows: int = 0         # backing/mmap rows served (hot-tier misses)
    tier1_bytes: int = 0
    tier2_bytes: int = 0
    upload_bytes: int = 0       # plan-carried feature bytes shipped to dev
    readahead_s: float = 0.0    # blocking tier-2→tier-1 install time at the
    #                             epoch boundary (forecast overlap excluded)
    # --- resilience (zeros when the policy is off) ---
    faults_injected: int = 0    # FaultPlan firings during this epoch
    comm_retries: int = 0       # transient exchange failures re-issued
    comm_timeouts: int = 0      # exchanges that exhausted retries/deadline
    bg_errors: int = 0          # background-thread failures recorded
    epoch_attempts: int = 1     # 1 = clean; >1 = replays after recovery
    rollbacks: int = 0          # NaN/Inf rollbacks to the epoch snapshot
    degradations: tuple = ()    # ladder rungs taken while running this epoch
    # --- feature integrity (the store's crc32 checks) ---
    crc_failures: int = 0       # backing-tier checksum mismatches this epoch
    repaired_rows: int = 0      # rows re-gathered from the source after a
    #                             quarantined chunk failed verification
    # --- membership (static world: generation 0, 0 recoveries) ---
    membership_generation: int = 0   # world generation at epoch end
    membership_recoveries: int = 0   # confirmed peer deaths recovered while
    #                                  running this epoch (rejoin or shrink)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item: {item})")


class Trainer:
    """Compile-once training loop over the repro_torch.core planner and
    engine."""

    def __init__(self, *, graph, labels, part, owner, local_idx, table,
                 cfg: GNNConfig,
                 optimizer: Optional[Optimizer] = None,
                 params=None,
                 strategy: Strategy = "hopgnn",
                 pregather: bool = True,
                 merging: Optional[bool] = None,
                 selector: str = "min",
                 mesh=None,
                 budget: Optional[ShapeBudget] = None,
                 prefetch: bool = True,
                 planner_threads: Optional[int] = None,
                 train_vertices: Optional[np.ndarray] = None,
                 root_fn: Optional[Callable[[int, int], Sequence]] = None,
                 root_seed: int = 0,
                 sample_seed_base: int = 0,
                 init_seed: int = 0,
                 ckpt_dir: Optional[str] = None,
                 ckpt_keep: int = 3,
                 cache_policy: Optional[str] = None,
                 cache_budget_bytes: int = 0,
                 cache_prefetch: bool = True,
                 pipeline: bool = True,
                 pipeline_stack: int = 1,
                 fused: Optional[bool] = None,
                 loss_sync_iters: int = 16,
                 fold_returns: Optional[bool] = None,
                 resilience=None,
                 device=None):
        if mesh is not None:
            raise _not_ported("training over a device mesh",
                              "8, multi-GPU ShardComm over NCCL")
        self.device = resolve_device(device)
        self.graph = graph
        self.labels = np.asarray(labels)
        self.part = np.asarray(part)
        self.owner = np.asarray(owner)
        self.local_idx = np.asarray(local_idx)
        # every feature read goes through one store: a plain
        # (N, local_rows, d) array is wrapped resident; a tiered store
        # switches the engine to streamed mode (plans carry their feature
        # blocks, no device table)
        if isinstance(table, FeatureStore):
            self.store = table.bind(self.owner, self.local_idx)
        else:
            self.store = FeatureStore.from_array(
                np.asarray(table), owner=self.owner,
                local_idx=self.local_idx)
        self.streamed = not self.store.resident
        if self.streamed and not pregather:
            raise ValueError(
                "a tiered FeatureStore requires pregather=True: per-step "
                "exchange gathers from a device-resident table, which "
                "out-of-core mode exists to avoid")
        # device-resident once, not re-uploaded per iteration
        self.table = self._device_table()
        self.cfg = cfg
        self.optimizer = optimizer or adamw(1e-3)
        self.pipeline = bool(pipeline)
        self.pipeline_stack = max(1, int(pipeline_stack))
        # fused defaults ON regardless of pipeline: pipeline=False alone is
        # the blocking-but-fused loop (identical to pipelined); the
        # grads-then-update path needs an explicit fused=False
        self.fused = True if fused is None else bool(fused)
        if self.pipeline and not self.fused:
            raise ValueError("pipeline=True requires the fused train step "
                             "(fused=False only with pipeline=False)")
        self.loss_sync_iters = int(loss_sync_iters)
        self.fold_returns = fold_returns
        if params is None:
            params = init_gnn(cfg, torch.Generator().manual_seed(init_seed),
                              self.device)
        else:
            # updates run in place: copy once so the caller's module stays
            # as it was given
            params = copy.deepcopy(params).to(self.device)
        self.params = params
        self.opt_state = self.optimizer.init(self.params)
        self._uploader: Optional[PlanUploader] = None   # created in fit()
        self.strategy: Strategy = strategy
        self.pregather = pregather
        self.merging = (strategy == "hopgnn") if merging is None else merging
        self.selector = selector
        self.budget = budget if budget is not None else ShapeBudget()
        self.train_vertices = (None if train_vertices is None
                               else np.asarray(train_vertices))
        self.root_fn = root_fn
        self.root_seed = root_seed
        self.sample_seed_base = sample_seed_base
        self.ckpt_dir = ckpt_dir
        self.ckpt_keep = ckpt_keep
        self.controller: Optional[MergingController] = None
        self.global_step = 0
        self._resume_pattern: Optional[tuple] = None  # (steps, frozen, time)
        self._prefetch = prefetch
        # Planning pool contract: build_plan fans its per-(shard, step)
        # sampling and per-shard index translation out on this pool; it is
        # distinct from the single prefetch thread, which double-buffers
        # whole plans. planner_threads <= 1 disables the pool.
        if planner_threads is None:
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:          # non-Linux
                cores = os.cpu_count() or 1
            planner_threads = min(4, cores)
        self.planner_threads = int(planner_threads)
        self._plan_pool: Optional[ThreadPoolExecutor] = None  # lazy
        self._plan_time_lock = threading.Lock()
        self._plan_time_acc = 0.0
        self._plans_built_acc = 0
        # --- remote-feature cache (repro_torch.cache) ---
        self.cache_policy_name = cache_policy
        self.cache_prefetch = bool(cache_prefetch)
        self.cache_rows = 0
        self.cache_store = None
        self._cache_policy = None
        self._cache_prefetcher = None
        self._cache_lock = threading.Lock()
        self._cache_fut = None
        self._prefetch_batch = 0           # bound per fit() call
        if cache_policy:
            from repro_torch.cache import CacheStore, budget_rows, make_policy
            d = self.store.feature_dim
            self.cache_rows = budget_rows(cache_budget_bytes, d,
                                          self.store.dtype.itemsize)
            if self.cache_rows > 0:
                # pre-size to the budget's pow2 bucket: a cold (even empty)
                # cache already has its final device shape
                self.cache_store = CacheStore(
                    self.num_shards, d, c_max=next_bucket(self.cache_rows),
                    dtype=self.store.dtype, device=self.device)
                self._cache_policy = make_policy(
                    cache_policy, graph=self.graph, owner=self.owner,
                    num_shards=self.num_shards)
                self._cache_prefetcher = self._make_prefetcher()
        # --- tiered-store readahead (streamed mode): the exact next-epoch
        # forecast that refreshes the device cache also drives tier-2 →
        # tier-1 promotion, so a prefetcher exists whenever the store is
        # tiered, cache layer or not
        self._readahead_fut = None
        self._readahead_enabled = self.streamed and self.store.hot_rows > 0
        if self._readahead_enabled and self._cache_prefetcher is None:
            self._cache_prefetcher = self._make_prefetcher()
        # --- resilience (None/True -> the default policy, False -> off).
        # The default policy is always on and cheap: one params/opt
        # snapshot per epoch, a deque peek per dispatch, an isfinite on
        # each synced loss window.
        self.resilience = ResiliencePolicy.resolve(resilience)
        self._supervisor = (ThreadSupervisor()
                            if self.resilience is not None else None)
        self._comm_counters = CommCounters()
        self._inline_planning = False      # degraded: plans built inline
        self._site_failures: dict = {}     # site -> failures seen this fit
        self._rollbacks_total = 0
        self.degradations_taken: list = []  # cumulative rung log
        # --- membership: per-shard liveness plus the world generation
        # every plan is stamped with (and refused under when it goes stale)
        self.membership = (MembershipView(self.num_shards)
                           if self.resilience is not None
                           and self.resilience.membership else None)
        self.membership_recoveries = 0     # confirmed deaths recovered
        self._membership_ckpt_loaded = False  # the last recovery resumed
        #                                       from the shared checkpoint
        # one record per failed epoch attempt: the error, the rung taken,
        # the attempt's wall time up to the failure (``lost_s``) and the
        # recovery's own (``recover_s``)
        self.recovery_log: list = []

    def _make_prefetcher(self):
        from repro_torch.cache.prefetch import EpochPrefetcher
        return EpochPrefetcher(
            graph=self.graph, part=self.part, owner=self.owner,
            num_shards=self.num_shards,
            num_layers=self.cfg.num_layers, fanout=self.cfg.fanout,
            roots_for=self._prefetch_roots_for,
            sample_seed_for=lambda e, i:
                self.sample_seed_base + e * 10_000 + i,
            strategy=self.strategy,
            fold_steps=self._prefetch_fold)

    # ------------------------------------------------------------------
    # Host-side planning (runs on the prefetch thread)
    # ------------------------------------------------------------------

    @property
    def num_shards(self) -> int:
        return self.store.num_shards

    def _device_table(self) -> Optional[torch.Tensor]:
        """The resident store's (N, local_rows, d) table on the device;
        None for a tiered store (streamed mode has no device table)."""
        if not self.store.resident:
            return None
        return engine.upload(self.store.as_dense(), self.device)

    def _roots_for(self, epoch: int, it: int, batch_per_model: int):
        if self.root_fn is not None:
            return [np.asarray(r, np.int64)
                    for r in self.root_fn(epoch, it)]
        if self.train_vertices is None:
            raise ValueError("need train_vertices (or a root_fn)")
        rng = np.random.default_rng((self.root_seed, epoch, it))
        return [rng.choice(self.train_vertices, batch_per_model,
                           replace=False)
                for _ in range(self.num_shards)]

    def _assignment_for(self, roots):
        """Merge-pattern application: fold each fresh rotation assignment
        to the controller's current depth."""
        if self.strategy != "hopgnn" or not self.merging:
            return None
        base = hopgnn_assignment(roots, self.part)
        if self.controller is None:
            self.controller = MergingController(base=base,
                                                selector=self.selector)
            if self._resume_pattern is not None:
                steps, frozen, last_time = self._resume_pattern
                if steps:
                    self.controller.restore(steps, frozen,
                                            last_time=last_time)
                self._resume_pattern = None
        return self.controller.apply_to(base)

    def build_plan(self, epoch: int, it: int,
                   batch_per_model: int) -> IterationPlan:
        with obs_span("plan.build", epoch=epoch, it=it):
            return self._build_plan(epoch, it, batch_per_model)

    def _build_plan(self, epoch: int, it: int,
                    batch_per_model: int) -> IterationPlan:
        t0 = time.perf_counter()
        # fault points: fire only under an installed FaultPlan, and thread
        # death only when this thread is supervised as "prefetch" (the
        # inline-planning fallback must not re-trip the same fault)
        _rfaults.sleep_point("prefetch", epoch, it)
        _rfaults.raise_if_thread("prefetch", epoch, it)
        roots = self._roots_for(epoch, it, batch_per_model)
        assignment = self._assignment_for(roots)
        cache_index = (self.cache_store.index
                       if self.cache_store is not None else None)
        plan = self.budget.plan(
            graph=self.graph, labels=self.labels, part=self.part,
            owner=self.owner, local_idx=self.local_idx,
            local_rows=self.store.local_rows,
            roots_per_model=roots, num_layers=self.cfg.num_layers,
            fanout=self.cfg.fanout, strategy=self.strategy,
            pregather=self.pregather, assignment=assignment,
            cache_index=cache_index,
            feature_store=self.store if self.streamed else None,
            executor=self._get_plan_pool(),
            sample_seed=self.sample_seed_base + epoch * 10_000 + it)
        if self._cache_policy is not None and not self._cache_policy.static \
                and not self.cache_prefetch and plan.remote_ids is not None:
            # trailing-LFU mode: learn frequencies from the requests the
            # plans actually made (prefetch mode predicts them instead)
            with self._cache_lock:
                for s in range(self.num_shards):
                    self._cache_policy.observe(s, plan.remote_ids[s])
        plan.epoch_it = (epoch, it)   # provenance for the comm fault point
        # world provenance: the membership generation this plan was built
        # under; _dispatch refuses the plan once the generation moves on
        plan.generation = (self.membership.generation
                           if self.membership is not None else -1)
        uploader = self._uploader
        if uploader is not None:
            # async pipeline: commit the upload here, on the prefetch
            # thread, so plan i+1's transfer overlaps plan i's execution.
            # The commit runs under the "uploader" site so an injected
            # uploader death is told apart from a planner death (they
            # degrade differently: uploader_off vs pipeline_to_sync).
            with obs_span("upload.commit", track="uploader",
                          epoch=epoch, it=it):
                if _rfaults.current_site.get() is not None:
                    tok = _rfaults.current_site.set("uploader")
                    try:
                        _rfaults.raise_if_thread("uploader", epoch, it)
                        uploader.commit(plan)
                    finally:
                        _rfaults.current_site.reset(tok)
                else:
                    uploader.commit(plan)
        with self._plan_time_lock:
            self._plan_time_acc += time.perf_counter() - t0
            self._plans_built_acc += 1
        return plan

    def _get_plan_pool(self) -> Optional[ThreadPoolExecutor]:
        """Planning pool, created on first use and torn down with fit()."""
        if self._plan_pool is None and self.planner_threads > 1:
            self._plan_pool = ThreadPoolExecutor(
                max_workers=self.planner_threads, thread_name_prefix="plan")
        return self._plan_pool

    def _close_plan_pool(self) -> None:
        pool, self._plan_pool = self._plan_pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    def _drain_plan_stats(self) -> tuple[float, int]:
        with self._plan_time_lock:
            out = (self._plan_time_acc, self._plans_built_acc)
            self._plan_time_acc = 0.0
            self._plans_built_acc = 0
        return out

    # ------------------------------------------------------------------
    # Remote-feature cache (repro_torch.cache)
    # ------------------------------------------------------------------

    @property
    def cache_enabled(self) -> bool:
        return self.cache_store is not None

    def _prefetch_roots_for(self, epoch: int, it: int):
        """Deterministic root replay for the epoch prefetcher (the draw
        build_plan will make)."""
        return self._roots_for(epoch, it, self._prefetch_batch)

    def _prefetch_fold(self, amat):
        """Fold the predicted rotation exactly like build_plan will, so an
        active §5.3 merge does not shift requests away from the predicted
        hot sets. Exact for the deterministic "min" selector; the random
        selector's folds consume controller state and stay unfolded."""
        ctl = self.controller
        if (ctl is None or self.strategy != "hopgnn" or not self.merging
                or self.selector != "min"):
            return amat
        return fold_assignment(amat, ctl.pattern_steps, self.selector)

    def _cache_select_install(self) -> dict:
        """Run the admission policy and refresh the device cache straight
        from the FeatureStore."""
        with self._cache_lock:
            sel = [self._cache_policy.select(s, self.cache_rows)
                   for s in range(self.num_shards)]
        return self.cache_store.install_from(self.store, sel)

    def _cache_compute(self, epoch: int, iters: int):
        """Cache-thread job: predict the epoch's requests (deterministic
        sampler), select the cached set, gather its rows."""
        with obs_span("cache.forecast", epoch=epoch):
            _rfaults.sleep_point("cache", epoch, -1)
            _rfaults.raise_if_thread("cache", epoch, -1)
            hot = self._cache_prefetcher.epoch_requests(epoch, iters)
            with self._cache_lock:
                sel = [self._cache_policy.select(s, self.cache_rows,
                                                 hot_ids=ids, hot_counts=cnt)
                       for s, (ids, cnt) in enumerate(hot)]
            rows = [self._features_of(ids) for ids in sel]
            return sel, rows

    def _cache_epoch_begin(self, epoch: int, first_epoch: int, epochs: int,
                           iters: int, batch_per_model: int,
                           cache_exec) -> float:
        """Refresh the store at the epoch boundary (this epoch's plans are
        built only after this returns) and schedule the next epoch's
        prefetch. Returns the *blocking* refresh seconds."""
        if not self.cache_enabled:
            return 0.0
        with obs_span("cache.refresh", epoch=epoch):
            t0 = time.perf_counter()
            self._prefetch_batch = batch_per_model
            if self._cache_fut is not None:
                ids, rows = self._cache_fut.result()
                self._cache_fut = None
                self.cache_store.install(ids, rows)
            elif epoch == first_epoch and self._cache_policy.static:
                # degree policy: one static selection, installed before the
                # first plan and never refreshed
                self._cache_select_install()
            elif not self._cache_policy.static and cache_exec is None \
                    and epoch > first_epoch:
                # trailing LFU (prefetch off): select from frequencies
                # observed in earlier epochs' plans
                self._cache_select_install()
            if cache_exec is not None and not self._cache_policy.static \
                    and epoch + 1 < epochs:
                self._cache_fut = self._submit_site(
                    cache_exec, "cache", self._cache_compute, epoch + 1,
                    iters)
            # upload now, so it lands in cache_refresh_s and not inside the
            # first (steady-timed) step of the epoch
            self.cache_store.device_table
            return time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Tiered-store readahead (tier 2 -> tier 1)
    # ------------------------------------------------------------------

    def _readahead_compute(self, epoch: int, iters: int):
        """Cache-thread job: the per-OWNING-shard (ids, counts) forecast of
        every row each shard will *serve* next epoch — exact under the
        deterministic sampler, the same replay the cache refresh uses."""
        with obs_span("features.readahead.forecast", epoch=epoch):
            _rfaults.sleep_point("readahead", epoch, -1)
            _rfaults.raise_if_thread("readahead", epoch, -1)
            return self._cache_prefetcher.epoch_touched(epoch, iters)

    def _readahead_install(self, touched) -> int:
        """Swap the forecast rows into each shard's host hot tier. Sorted by
        backing row so the store's unique() keeps counts aligned."""
        installed = 0
        for p, (ids, cnt) in enumerate(touched):
            rows = self.local_idx[ids]
            order = np.argsort(rows, kind="stable")
            installed += self.store.readahead(p, rows[order],
                                              counts=cnt[order])
        return installed

    def _readahead_epoch_begin(self, epoch: int, epochs: int, iters: int,
                               batch_per_model: int, cache_exec) -> float:
        """Promote next epoch's rows at the epoch boundary — no plan is in
        flight then, so the wholesale hot-tier swap never races a gather
        (the store's thread contract). The forecast for epoch e+1 runs on
        the cache thread *during* epoch e; only the first epoch (and the
        install itself) block. Runs BEFORE the cache refresh so its gathers
        hit the freshly warmed hot tier. Returns the blocking seconds."""
        if not self._readahead_enabled:
            return 0.0
        with obs_span("features.readahead", epoch=epoch):
            t0 = time.perf_counter()
            self._prefetch_batch = batch_per_model
            if self._readahead_fut is not None:
                touched = self._readahead_fut.result()
                self._readahead_fut = None
                self._readahead_install(touched)
            else:
                self._readahead_install(
                    self._readahead_compute(epoch, iters))
            if cache_exec is not None and epoch + 1 < epochs:
                self._readahead_fut = self._submit_site(
                    cache_exec, "readahead", self._readahead_compute,
                    epoch + 1, iters)
            return time.perf_counter() - t0

    def _submit_site(self, exec_, site: str, fn, *args):
        """Submit a background job under supervision (site and (epoch, it)
        context recorded at raise time; see repro_torch.resilience)."""
        if self._supervisor is None:
            return exec_.submit(fn, *args)
        return self._supervisor.submit(exec_.submit, site, fn, *args,
                                       epoch=args[0] if args else -1, it=-1)

    # ------------------------------------------------------------------
    # Device stepping
    # ------------------------------------------------------------------

    def _cache_table_for(self, plan: IterationPlan):
        """Device cache table for this plan, with the staleness check.
        Cache-off plans share one zero-width table."""
        if plan.c_max:
            store = self.cache_store
            if store is None or plan.cache_version != store.version:
                raise RuntimeError(
                    f"stale cache plan: plan version {plan.cache_version} "
                    f"vs store "
                    f"{store.version if store is not None else 'absent'}")
            return store.device_table
        return self._empty_table()

    def _empty_table(self) -> torch.Tensor:
        """The shared (N, 0, d) zero-width device table: it stands in for a
        disabled cache and, in streamed mode, for the absent feature
        table."""
        return engine.empty_cache_table(
            self.num_shards, self.store.feature_dim,
            engine.torch_dtype(self.store.dtype), self.device)

    def train_step(self, plan: IterationPlan):
        """Grads, then the optimizer update as a separate call (the
        ``fused=False`` path). Returns the device loss."""
        cache_tab = self._cache_table_for(plan)
        grads, loss = engine.run_iteration(self.params, self.table, plan,
                                           self.cfg, cache=cache_tab,
                                           fold_returns=self.fold_returns,
                                           device=self.device)
        self.params, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params)
        self.global_step += 1
        return loss

    def _dispatch_fused(self, plan: IterationPlan, fault_point: bool = True):
        """One fused call: iteration + optimizer update. Returns the
        *device* loss — no host sync happens here. ``fault_point=False``
        when the caller already ran the plan's comm fault point."""
        cache_tab = self._cache_table_for(plan)
        fn = engine.get_compiled_train_step(
            self.cfg, plan.pregather, self.optimizer,
            fold_returns=engine.resolve_fold_returns(plan,
                                                     self.fold_returns),
            streamed=plan.streamed)
        table, cache_tab, dev, denom = engine.prepare_iteration_args(
            self.table, plan, cache_tab, device=self.device,
            fault_point=fault_point)
        self.params, self.opt_state, loss = fn(
            self.params, self.opt_state, table, cache_tab, dev, denom)
        self.global_step += 1
        return self._maybe_poison([plan], loss)

    def _dispatch_stacked(self, plans: Sequence[IterationPlan]):
        """One call covering ``len(plans)`` same-bucket iterations
        (pipeline_stack > 1). Returns the (K,) device losses."""
        p0 = plans[0]
        split = False
        for p in plans[1:]:
            if (p.pregather != p0.pregather
                    or p.cache_version != p0.cache_version
                    or p.num_steps != p0.num_steps):
                raise ValueError("stacked plans must share mode, cache "
                                 "version, and merge pattern")
            split |= ((p.batch_pad, p.r_max, p.c_max, p.l_max)
                      != (p0.batch_pad, p0.r_max, p0.c_max, p0.l_max))
        # the host comm boundary of every plan in the group, before any
        # in-place update: the retry guard reruns the whole group, so a
        # fault on a later plan must not find an earlier one applied
        for p in plans:
            engine.comm_fault_point(p)
        if split:
            # a mid-epoch budget re-bucket split the group's shapes:
            # dispatch one by one (one new signature, as unstacked)
            return torch.stack([self._dispatch_fused(q, fault_point=False)
                                for q in plans])
        cache_tab = self._cache_table_for(p0)
        fn = engine.get_compiled_train_step(
            self.cfg, p0.pregather, self.optimizer,
            fold_returns=engine.resolve_fold_returns(p0, self.fold_returns),
            stacked=True, streamed=p0.streamed)
        devs, denoms = stack_committed(plans, self.device)
        table = self.table if self.table is not None else self._empty_table()
        self.params, self.opt_state, losses = fn(
            self.params, self.opt_state, table, cache_tab, devs, denoms)
        self.global_step += len(plans)
        return self._maybe_poison(plans, losses)

    # ------------------------------------------------------------------
    # Resilience plumbing (repro_torch.resilience)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _maybe_poison(self, plans, loss):
        """nan_loss fault point: poison this step's loss AND the live
        parameters in place (numerical divergence — recovery needs the
        rollback, not just dropping one loss sample). No-op without an
        active plan."""
        if _rfaults.active_plan() is None:
            return loss
        for p in plans:
            ei = getattr(p, "epoch_it", None)
            if ei is None or not _rfaults.take("nan_loss", ei[0], ei[1]):
                continue
            for leaf in self.params.leaves():
                if leaf.is_floating_point():
                    leaf.mul_(float("nan"))
            loss = loss * float("nan")
        return loss

    def _dispatch(self, plans: Sequence[IterationPlan], epoch: int = -1,
                  it: int = -1):
        """Guarded dispatch used by both epoch loops: refuse a plan of an
        older world, surface any pending background error (the "next
        dispatch boundary" contract), then run the dispatch under the comm
        retry guard. Transient comm faults fire during argument staging,
        BEFORE the in-place update (a stacked group runs every plan's fault
        point first), so a retry never applies a step twice."""
        if self.membership is not None:
            for p in plans:
                self.membership.check_generation(
                    getattr(p, "generation", -1), epoch=epoch, it=it)
        if self._supervisor is not None:
            self._supervisor.check()
        if len(plans) > 1:
            fn = lambda: self._dispatch_stacked(plans)  # noqa: E731
        elif self.fused:
            fn = lambda: self._dispatch_fused(plans[0])  # noqa: E731
        else:
            fn = lambda: self.train_step(plans[0])  # noqa: E731
        if self.resilience is None:
            return fn()
        return resilient_call(fn, policy=self.resilience.retry,
                              counters=self._comm_counters,
                              epoch=epoch, it=it)

    def _abandon(self, futures, exc: BaseException) -> None:
        """An epoch attempt failed with plan builds in flight: cancel the
        ones not started and wait for a running one (up to the stall
        deadline; not after a stall, whose build is the one wedged). So no
        build of the abandoned attempt still commits an upload or records
        an error while the Trainer recovers, and a world change never
        races a build of the old world. The replay rebuilds every plan."""
        running = [f for f in futures
                   if isinstance(f, Future) and not f.cancel()]
        if running and not isinstance(exc, StallError):
            policy = self.resilience
            futures_wait(running, timeout=None if policy is None
                         else policy.stall_deadline_s)

    def _plan_result(self, fut, epoch: int, it: int):
        """Wait for a plan future under the stall deadline — a wedged
        prefetch thread becomes a StallError instead of hanging fit().
        The wait is on the future alone, never on the device."""
        policy = self.resilience
        if policy is None or policy.stall_deadline_s is None:
            return fut.result()
        try:
            return fut.result(timeout=policy.stall_deadline_s)
        except (TimeoutError, FuturesTimeout):
            raise StallError("prefetch", epoch, it,
                             policy.stall_deadline_s) from None

    def _check_finite(self, loss, epoch: int, it: int) -> None:
        """NaN/Inf guard on a synced loss window (a device tensor is read
        back here, after the window's sync; floats pass through)."""
        policy = self.resilience
        if policy is None or not policy.guard_nonfinite:
            return
        if isinstance(loss, torch.Tensor):
            loss = loss.detach().cpu().numpy()
        v = np.asarray(loss, np.float64).ravel()
        if not np.all(np.isfinite(v)):
            raise NonFiniteLoss(epoch, it, float(v[~np.isfinite(v)][0]))

    def _snapshot_state(self) -> dict:
        """Epoch-start in-memory snapshot for rollback and replay: clones
        of every tensor, since the update overwrites the live ones in
        place (the int32 step included)."""
        return {"params": [t.detach().clone() for t in self.params.leaves()],
                "opt": tree_clone(self.opt_state),
                "step": self.global_step}

    @torch.no_grad()
    def _restore_state(self, snap: dict) -> None:
        """Copy the snapshot back into the live tensors — copied again, so
        the snapshot survives a second rollback."""
        for dst, src in zip(self.params.leaves(), snap["params"]):
            dst.copy_(src)
        self.opt_state = tree_clone(snap["opt"])
        self.global_step = snap["step"]

    def _degrade(self, site: Optional[str]) -> Optional[str]:
        """Take one degradation-ladder rung for a failing site. Every rung
        lands on a mode that is bit-identical to the one it leaves (the
        pipelined and synchronous loops run the same operations in the
        same order; a cache hit reads the row a fetch would; a hot-tier row
        equals its backing row) — recovery costs throughput, never
        numerics."""
        if site == "uploader" and self._uploader is not None:
            # plans stop committing; dispatch uploads them inline
            self._uploader = None
            return "uploader_off"
        if site in ("prefetch", "uploader", "comm"):
            if self.pipeline or not self._inline_planning:
                self.pipeline = False
                self._inline_planning = True
                self._uploader = None
                return "pipeline_to_sync"
            return None
        if site == "cache":
            if self.cache_store is not None:
                self.cache_store = None
                self._cache_policy = None
                self._cache_fut = None
                return "cache_off"
            return None
        if site in ("readahead", "store") and self.streamed:
            # (a resident store has no hot tier to bypass: no rung)
            if self._readahead_enabled or not self.store.hot_bypass:
                # plan gathers read the backing tier directly
                self._readahead_enabled = False
                self._readahead_fut = None
                self.store.bypass_hot(True)
                return "resident_gather"
            return None
        return None

    def _recover(self, e: BaseException, epoch: int) -> Optional[str]:
        """Decide the recovery action for a failed epoch attempt. First
        failure of a site replays in-mode (transients and once-faults clear
        on replay); a repeat failure takes the site's ladder rung. NaN/Inf
        always means rollback and replay, bounded by ``max_rollbacks``.
        Before either, the uploader's side stream is drained: the
        abandoned attempt may still be copying into buffers the replay's
        plans reuse."""
        policy = self.resilience
        site = getattr(e, "site", None)
        if isinstance(e, BackgroundError):
            self._supervisor.mark_delivered(e)
            site = getattr(e.__cause__, "site", site)
        self._supervisor.drain()
        if self._uploader is not None:
            self._uploader.drain()
        # abandon the in-flight epoch-boundary futures: the replay
        # recomputes them deterministically at its own boundary
        self._cache_fut = None
        self._readahead_fut = None
        # membership: a peer-attributed failure goes through detection
        # first — a confirmed death is a world change, not a site failure
        if self.membership is not None and policy.membership:
            peer = peer_of(e)
            if peer >= 0 and self.membership.is_alive(peer):
                rung = self._membership_recover(peer, epoch)
                if rung is not None:
                    self.degradations_taken.append(rung)
                    return rung
                # the probe found the peer alive (a flap): suspicion is
                # cleared with zero membership trace, and the failure falls
                # through to the ordinary comm site accounting below
        if isinstance(e, NonFiniteLoss):
            self._rollbacks_total += 1
            if self._rollbacks_total > policy.max_rollbacks:
                raise CheckpointRollbackExhausted(
                    f"non-finite loss persisted across "
                    f"{policy.max_rollbacks} rollback+replay attempts at "
                    f"epoch {epoch} — genuine divergence") from e
            return "rollback_replay"
        n = self._site_failures.get(site, 0) + 1
        self._site_failures[site] = n
        if n >= 2 and policy.degrade:
            rung = self._degrade(site)
            if rung is not None:
                self.degradations_taken.append(rung)
            return rung
        return None

    # ------------------------------------------------------------------
    # Elastic membership (repro_torch.membership)
    # ------------------------------------------------------------------

    def _membership_recover(self, peer: int, epoch: int) -> Optional[str]:
        """Two-phase recovery for a peer-attributed failure: suspect, then
        a bounded liveness probe. A peer that answers any probe was a flap
        — the suspicion is cleared and ``None`` returned (the caller
        replays in-mode, zero numerical trace). A confirmed death rebuilds
        the world per ``policy.membership_mode`` and resumes from the
        shared crash-atomic checkpoint; returns ``membership_<mode>``."""
        policy = self.resilience
        view = self.membership
        view.mark_suspect(peer, epoch=epoch)
        with obs_span("membership.detect", peer=peer, epoch=epoch):
            pr = PeerProbe(attempts=policy.probe_attempts,
                           backoff_s=policy.probe_backoff_s).confirm(peer)
        if pr.alive:
            view.clear_suspect(peer)
            return None
        view.confirm_dead(peer, epoch=epoch)
        mode = policy.membership_mode
        with obs_span("membership.rebuild", peer=peer, mode=mode,
                      epoch=epoch):
            if mode == "rejoin":
                # a replacement worker takes the dead rank: the partition
                # maps are unchanged and the rank's feature rows come back
                # from the authoritative source, so the world is the old
                # world under a fresh generation
                engine.revive_peer(peer)
                view.rejoin(peer, epoch=epoch)
            else:
                self._membership_shrink(peer, epoch, mode)
        with obs_span("membership.resume", peer=peer, mode=mode,
                      epoch=epoch):
            self._membership_ckpt_loaded = self._resume_shared_checkpoint()
        self.membership_recoveries += 1
        obs_metrics.inc("membership.recoveries")
        return f"membership_{mode}"

    def _membership_shrink(self, dead: int, epoch: int, mode: str) -> None:
        """Elastic re-ownership at world size P-1: survivors re-own the
        dead shard's vertices and every world-shaped structure is rebuilt
        against the new maps — the feature table (re-uploaded), the cache
        store, the epoch prefetcher and the uploader (``_recover`` drained
        its side stream). The ``(N, 0, d)`` empty cache is keyed by N in the
        engine, so the new world gets its own; the ShapeBudget's buckets
        are keyed by merge pattern, and a new world's plans re-bucket when
        they outgrow them. Numerics legitimately change (other shard
        batches, other reduction groups), so correctness is held to a loss
        tolerance against a fresh run at the same world size."""
        from repro_torch.membership import rebuild_world
        wr = rebuild_world(self.part, dead, self.num_shards, mode=mode)
        # the dead rank leaves the world entirely; its registry entry must
        # not leak into the compacted id space
        engine.revive_peer(dead)
        self.part, self.owner = wr.part, wr.owner
        self.local_idx = wr.local_idx
        self.store = self.store.reshard(wr.part, wr.num_shards)
        self.streamed = not self.store.resident
        self.table = self._device_table()
        # merge controller: the base rotation assignment is world-shaped;
        # the §5.3 examination restarts against the new world
        self.controller = None
        self._resume_pattern = None
        # cache layer: rebuilt cold against the new owner map (the same
        # row budget per shard)
        if self.cache_store is not None:
            from repro_torch.cache import CacheStore, make_policy
            self.cache_store = CacheStore(
                self.num_shards, self.store.feature_dim,
                c_max=next_bucket(self.cache_rows), dtype=self.store.dtype,
                device=self.device)
            self._cache_policy = make_policy(
                self.cache_policy_name, graph=self.graph, owner=self.owner,
                num_shards=self.num_shards)
        self._cache_fut = None
        self._readahead_fut = None
        self._readahead_enabled = self.streamed and self.store.hot_rows > 0
        self._cache_prefetcher = (
            self._make_prefetcher()
            if self.cache_store is not None or self._readahead_enabled
            else None)
        if self._uploader is not None:
            self._uploader = PlanUploader(budget=self.budget,
                                          device=self.device,
                                          view=self.membership)
        self.membership.shrink(dead, epoch=epoch)

    def _resume_shared_checkpoint(self) -> bool:
        """Reload params and optimizer state from the shared crash-atomic
        checkpoint — the survivors' common restore point. False when no
        checkpoint exists yet; the epoch-start snapshot then serves
        instead (identical to the last checkpoint whenever one exists,
        because checkpoints are written at the epoch boundaries the
        snapshot is taken at)."""
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            return False
        tree, step, _extra = load_checkpoint(
            self.ckpt_dir, {"params": self.params, "opt": self.opt_state})
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.global_step = step
        return True

    def _attempt_epoch(self, epoch: int, start_epoch: int, epochs: int,
                       iters: int, batch_per_model: int, cache_exec,
                       submit):
        """One try at one epoch: inject any scheduled epoch-boundary disk
        faults (BEFORE readahead, so the checksum verification sees them),
        the boundary work, the iteration loop, then the NaN/Inf guard over
        the epoch's losses."""
        for sp in _rfaults.take("disk_corrupt", epoch):
            _rfaults.inject_disk_corruption(self.store, sp)
        readahead_s = self._readahead_epoch_begin(
            epoch, epochs, iters, batch_per_model, cache_exec)
        refresh_s = self._cache_epoch_begin(
            epoch, start_epoch, epochs, iters, batch_per_model, cache_exec)
        if self.pipeline:
            res = run_pipelined_epoch(
                self, epoch, iters, batch_per_model, submit,
                stack=self.pipeline_stack,
                loss_sync_iters=self.loss_sync_iters)
        else:
            res = self._epoch_sync(epoch, iters, batch_per_model, submit)
        self._check_finite(res.losses, epoch, iters - 1)
        return res, readahead_s, refresh_s

    _RECOVERABLE = (BackgroundError, StallError, CommTimeout, NonFiniteLoss,
                    InjectedFault, StaleGeneration)

    def _epoch_with_recovery(self, epoch: int, start_epoch: int,
                             epochs: int, iters: int, batch_per_model: int,
                             cache_exec, submit):
        """The epoch attempt loop: snapshot → attempt → on a recoverable
        failure restore + recover (replay or degrade) → re-attempt, up to
        ``max_epoch_attempts``. Determinism makes every replay exact: the
        same (epoch, it, seed) plans rebuild, so an absorbed fault leaves
        losses and parameters bit-identical to a fault-free run."""
        if self.resilience is None:
            res, ra, rf = self._attempt_epoch(epoch, start_epoch, epochs,
                                              iters, batch_per_model,
                                              cache_exec, submit)
            return res, ra, rf, {}
        self._comm_counters.reset()
        bg0 = self._supervisor.errors_recorded
        fp = _rfaults.active_plan()
        f0 = fp.fired_count() if fp is not None else 0
        rb0 = self._rollbacks_total
        mr0 = self.membership_recoveries
        snap = self._snapshot_state()
        attempts = 0
        rungs: list = []
        while True:
            attempts += 1
            t_attempt = time.perf_counter()
            try:
                res, ra, rf = self._attempt_epoch(
                    epoch, start_epoch, epochs, iters, batch_per_model,
                    cache_exec, submit)
                break
            except self._RECOVERABLE as e:
                if attempts >= self.resilience.max_epoch_attempts:
                    raise
                t0 = time.perf_counter()
                lost_s = t0 - t_attempt
                rung = self._recover(e, epoch)
                if rung is not None:
                    rungs.append(rung)
                if self._membership_ckpt_loaded:
                    # membership resumed from the shared checkpoint (the
                    # epoch-start state at every epoch boundary); the old
                    # snapshot may belong to a pre-shrink world — re-take
                    self._membership_ckpt_loaded = False
                    snap = self._snapshot_state()
                else:
                    self._restore_state(snap)
                self.recovery_log.append(dict(
                    epoch=epoch, attempt=attempts, error=type(e).__name__,
                    rung=rung, lost_s=lost_s,
                    recover_s=time.perf_counter() - t0))
        fp = _rfaults.active_plan()
        meta = {"epoch_attempts": attempts,
                "rollbacks": self._rollbacks_total - rb0,
                "degradations": tuple(rungs),
                "faults_injected":
                    (fp.fired_count() if fp is not None else 0) - f0,
                "comm_retries": self._comm_counters.retries,
                "comm_timeouts": self._comm_counters.timeouts,
                "bg_errors": self._supervisor.errors_recorded - bg0,
                "membership_recoveries":
                    self.membership_recoveries - mr0}
        return res, ra, rf, meta

    # ------------------------------------------------------------------
    # Epoch loop
    # ------------------------------------------------------------------

    def _epoch_sync(self, epoch: int, iters: int, batch_per_model: int,
                    submit) -> EpochRunResult:
        """Per-iteration blocking loop (``pipeline=False``): double-buffered
        plans, one ``float(loss)`` device sync per step."""
        t_epoch = time.perf_counter()
        fut = submit(self.build_plan, epoch, 0, batch_per_model)
        iter_times: list[float] = []
        traced: list[bool] = []
        losses: list[float] = []
        remote, num_steps, cache_hits = 0, 0, 0
        t1 = t2 = up = 0
        try:
            for it in range(iters):
                with obs_span("plan.wait", epoch=epoch, it=it):
                    plan = self._plan_result(fut, epoch, it)
                if it + 1 < iters:
                    # double-buffer: plan i+1 builds while i executes
                    fut = submit(self.build_plan, epoch, it + 1,
                                 batch_per_model)
                tc0 = engine.trace_count()
                t0 = time.perf_counter()
                with obs_span("dispatch", epoch=epoch, it=it):
                    loss = self._dispatch([plan], epoch, it)
                self._check_finite(loss, epoch, it)
                with obs_span("loss.sync", epoch=epoch, it=it):
                    losses.append(float(loss))   # waits for the device
                iter_times.append(time.perf_counter() - t0)
                traced.append(engine.trace_count() > tc0)
                remote += plan.remote_rows_exact
                cache_hits += plan.cache_hit_rows
                if plan.tier_stats:
                    t1 += plan.tier_stats["tier1_rows"]
                    t2 += plan.tier_stats["tier2_rows"]
                    up += plan.tier_stats["upload_bytes"]
                num_steps = plan.num_steps
        except BaseException as e:
            self._abandon([fut], e)
            raise
        steady = [t for t, tr in zip(iter_times, traced) if not tr]
        return EpochRunResult(
            losses=losses, wall_s=time.perf_counter() - t_epoch,
            steady_iter_s=float(np.mean(steady)) if steady else None,
            dispatch_s=0.0, traces=int(sum(traced)), remote_rows=remote,
            cache_hit_rows=cache_hits, num_steps=num_steps,
            tier1_rows=t1, tier2_rows=t2, upload_bytes=up)

    def fit(self, epochs: int, iters_per_epoch: int,
            batch_per_model: int = 16, eval_every: int = 0,
            n_eval: int = 256, resume: bool = False,
            log: Optional[Callable[[str], None]] = None
            ) -> list[EpochStats]:
        """Run the epoch loop; returns one :class:`EpochStats` per epoch.

        ``steady_time_s`` is the trace-free steady-state estimate that
        feeds the merging controller. In the synchronous loop it averages
        the iterations on which no new signature was traced; in the
        pipelined loop per-iteration walls are dispatch times, so it comes
        from the synced window after the last trace (see
        repro_torch.train.pipeline). If no trace-free sample exists the
        epoch is marked ``compile_free=False`` and is NOT recorded with the
        controller.

        ``resume=True`` continues from the newest durable checkpoint in
        ``ckpt_dir`` (parameters, optimizer state, merge pattern and
        budget state) at the epoch after it; when the checkpoint already
        covers every epoch the result is empty."""
        start_epoch = self._maybe_resume() if resume else 0
        stats: list[EpochStats] = []
        pool = (ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix="prefetch")
                if self._prefetch else None)
        if self._supervisor is None or pool is None:
            submit = pool.submit if pool is not None else self._run_inline
        else:
            def submit(fn, *args):
                # degraded rung: plans build inline on the loop thread
                # (synchronous, unsupervised — failures raise in place)
                if self._inline_planning:
                    return self._run_inline(fn, *args)
                return self._supervisor.submit(
                    pool.submit, "prefetch", fn, *args,
                    epoch=args[0] if args else -1,
                    it=args[1] if len(args) > 1 else -1)
        if self.pipeline and self._uploader is None:
            self._uploader = PlanUploader(budget=self.budget,
                                          device=self.device,
                                          view=self.membership)
        # the cache refresh computation gets its own thread: it must not
        # block the plan double-buffer (and vice versa). The tiered store's
        # readahead forecast shares it (both are epoch-boundary jobs on the
        # same deterministic replay; the single worker serializes them).
        need_cache_thread = (self.cache_enabled and self.cache_prefetch
                             and not self._cache_policy.static)
        cache_exec = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="cache")
                      if need_cache_thread or self._readahead_enabled
                      else None)
        try:
            for epoch in range(start_epoch, epochs):
                crc0 = (self.store.stats.crc_failures,
                        self.store.stats.repaired_rows)
                res, readahead_s, refresh_s, rmeta = \
                    self._epoch_with_recovery(
                        epoch, start_epoch, epochs, iters_per_epoch,
                        batch_per_model, cache_exec, submit)
                compile_free = res.steady_iter_s is not None
                steady_iter = (res.steady_iter_s if compile_free
                               else res.wall_s / iters_per_epoch)
                steady_epoch = steady_iter * iters_per_epoch
                if self.controller is not None and compile_free:
                    self.controller.record_epoch_time(steady_epoch)
                acc = (self.evaluate(n_eval=n_eval)
                       if eval_every and (epoch + 1) % eval_every == 0
                       else None)
                plan_time, plans_built = self._drain_plan_stats()
                row_bytes = self.store.row_bytes
                st = EpochStats(
                    epoch=epoch, loss=sum(res.losses) / iters_per_epoch,
                    time_s=res.wall_s, steady_time_s=steady_epoch,
                    traces=res.traces, num_steps=res.num_steps,
                    remote_rows=res.remote_rows, acc=acc,
                    compile_free=compile_free, plan_time_s=plan_time,
                    plans_built=plans_built,
                    cache_hit_rows=res.cache_hit_rows,
                    cache_hit_rate=res.cache_hit_rows
                    / max(res.cache_hit_rows + res.remote_rows, 1),
                    cache_bytes_saved=res.cache_hit_rows * row_bytes,
                    cache_refresh_s=refresh_s, pipelined=self.pipeline,
                    dispatch_s=res.dispatch_s, streamed=self.streamed,
                    tier1_rows=res.tier1_rows, tier2_rows=res.tier2_rows,
                    tier1_bytes=res.tier1_rows * row_bytes,
                    tier2_bytes=res.tier2_rows * row_bytes,
                    upload_bytes=res.upload_bytes, readahead_s=readahead_s,
                    faults_injected=rmeta.get("faults_injected", 0),
                    comm_retries=rmeta.get("comm_retries", 0),
                    comm_timeouts=rmeta.get("comm_timeouts", 0),
                    bg_errors=rmeta.get("bg_errors", 0),
                    epoch_attempts=rmeta.get("epoch_attempts", 1),
                    rollbacks=rmeta.get("rollbacks", 0),
                    degradations=rmeta.get("degradations", ()),
                    crc_failures=self.store.stats.crc_failures - crc0[0],
                    repaired_rows=self.store.stats.repaired_rows - crc0[1],
                    membership_generation=(self.membership.generation
                                           if self.membership is not None
                                           else 0),
                    membership_recoveries=rmeta.get(
                        "membership_recoveries", 0))
                stats.append(st)
                obs_metrics.publish_epoch_stats(st)
                if log is not None:
                    log(f"epoch {epoch}: loss {st.loss:.4f} "
                        f"steps {st.num_steps} remote_rows {st.remote_rows} "
                        f"traces {st.traces} wall {st.time_s:.2f}s "
                        f"steady {st.steady_time_s:.2f}s "
                        f"plan {st.plan_time_s:.2f}s"
                        + (f" cache-hit {100 * st.cache_hit_rate:.1f}%"
                           f" refresh {st.cache_refresh_s:.2f}s"
                           if self.cache_enabled else "")
                        + (f" t1-rows {st.tier1_rows} t2-rows "
                           f"{st.tier2_rows} readahead "
                           f"{st.readahead_s:.2f}s"
                           if self.streamed else "")
                        + ("" if st.compile_free else " (all-compile)")
                        + (f" attempts {st.epoch_attempts}"
                           + (f" degraded [{','.join(st.degradations)}]"
                              if st.degradations else "")
                           if st.epoch_attempts > 1 or st.degradations
                           else "")
                        + (f" acc {100 * acc:.1f}%" if acc is not None
                           else ""))
                self._maybe_checkpoint(epoch, st)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
            if cache_exec is not None:
                cache_exec.shutdown(wait=False, cancel_futures=True)
                self._cache_fut = None
                self._readahead_fut = None
            self._close_plan_pool()
        return stats

    @staticmethod
    def _run_inline(fn, *a):
        class _Done:
            def __init__(self, v):
                self._v = v

            def result(self, timeout=None):
                return self._v
        return _Done(fn(*a))

    # ------------------------------------------------------------------
    # Eval (features gathered back out of the sharded table)
    # ------------------------------------------------------------------

    def _features_of(self, ids: np.ndarray) -> np.ndarray:
        return self.store.take_global(ids)

    @torch.no_grad()
    def evaluate(self, n_eval: int = 256, seed: int = 123,
                 nodes: Optional[np.ndarray] = None) -> float:
        rng = np.random.default_rng(seed)
        num_vertices = self.part.shape[0]
        if nodes is None:
            nodes = rng.choice(num_vertices, min(n_eval, num_vertices),
                               replace=False)
        blk = sample_tree_block(self.graph, nodes, self.cfg.num_layers,
                                self.cfg.fanout, seed=999)
        feats = [engine.upload(self._features_of(ids), self.device)
                 for ids in blk.hops]
        labels = engine.upload(self.labels[nodes], self.device)
        return float(gnn_accuracy(self.params, self.cfg, feats, labels))

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------

    def _maybe_checkpoint(self, epoch: int, st: EpochStats) -> None:
        if not self.ckpt_dir:
            return
        extra = {"epoch": epoch, "loss": st.loss,
                 "merge_steps": (self.controller.pattern_steps
                                 if self.controller else 0),
                 "merge_frozen": (bool(self.controller.frozen)
                                  if self.controller else False),
                 "merge_last_time": (self.controller.last_epoch_time
                                     if self.controller else None),
                 # bucket state rides along so a resumed run plans straight
                 # into the original run's shapes — no probe, no new
                 # signature in its first epoch
                 "budget_state": self.budget.state_dict()}
        save_checkpoint(self.ckpt_dir, self.global_step,
                        {"params": self.params, "opt": self.opt_state},
                        extra=extra, keep=self.ckpt_keep)

    def _maybe_resume(self) -> int:
        if not self.ckpt_dir or latest_step(self.ckpt_dir) is None:
            return 0
        try:
            tree, step, extra = load_checkpoint(
                self.ckpt_dir, {"params": self.params, "opt": self.opt_state})
            self.params = tree["params"]
            self.opt_state = tree["opt"]
        except ValueError:
            # older checkpoints stored bare params (no optimizer state);
            # restore what exists and re-init the optimizer
            params, step, extra = load_checkpoint(self.ckpt_dir, self.params)
            self.params = params
            self.opt_state = self.optimizer.init(self.params)
        self.global_step = step
        bs = extra.get("budget_state")
        if bs:
            self.budget.load_state(bs)
        lt = extra.get("merge_last_time")
        self._resume_pattern = (int(extra.get("merge_steps", 0)),
                                bool(extra.get("merge_frozen", False)),
                                None if lt is None else float(lt))
        return int(extra.get("epoch", -1)) + 1

