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
* **Eval** — tree-block evaluation on features gathered back out of the
  sharded table.

Entry points run on ``cuda`` unless ``device="cpu"`` is given. Not ported
yet, each raising ``NotImplementedError`` that names its ROADMAP Queue 1
item: checkpoints (``ckpt_dir``, ``resume``), resilience (and with it
membership), a device ``mesh``, and a tiered FeatureStore (streamed
training).

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
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import distributed as engine
from repro_torch.core.merging import MergingController, fold_assignment
from repro_torch.core.micrograph import hopgnn_assignment
from repro_torch.core.strategies import IterationPlan, Strategy
from repro_torch.device import resolve_device
from repro_torch.features import FeatureStore
from repro_torch.graph.sampler import sample_tree_block
from repro_torch.models.gnn.models import GNNConfig, gnn_accuracy, init_gnn
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span as obs_span
from repro_torch.optim import Optimizer, adamw
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
        if ckpt_dir is not None:
            raise _not_ported("checkpointing", "2, checkpoints")
        if resilience not in (None, False):
            if getattr(resilience, "membership", False):
                raise _not_ported("membership", "4, membership")
            raise _not_ported("resilience", "3, resilience")
        self.device = resolve_device(device)
        self.graph = graph
        self.labels = np.asarray(labels)
        self.part = np.asarray(part)
        self.owner = np.asarray(owner)
        self.local_idx = np.asarray(local_idx)
        # every feature read goes through one store: a plain
        # (N, local_rows, d) array is wrapped resident
        if isinstance(table, FeatureStore):
            self.store = table.bind(self.owner, self.local_idx)
        else:
            self.store = FeatureStore.from_array(
                np.asarray(table), owner=self.owner,
                local_idx=self.local_idx)
        if not self.store.resident:
            raise _not_ported("a tiered FeatureStore (streamed training)",
                              "10, streamed training")
        # device-resident once, not re-uploaded per iteration
        self.table = engine.upload(self.store.as_dense(), self.device)
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
        self.controller: Optional[MergingController] = None
        self.global_step = 0
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
        return self.controller.apply_to(base)

    def build_plan(self, epoch: int, it: int,
                   batch_per_model: int) -> IterationPlan:
        with obs_span("plan.build", epoch=epoch, it=it):
            return self._build_plan(epoch, it, batch_per_model)

    def _build_plan(self, epoch: int, it: int,
                    batch_per_model: int) -> IterationPlan:
        t0 = time.perf_counter()
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
            executor=self._get_plan_pool(),
            sample_seed=self.sample_seed_base + epoch * 10_000 + it)
        if self._cache_policy is not None and not self._cache_policy.static \
                and not self.cache_prefetch and plan.remote_ids is not None:
            # trailing-LFU mode: learn frequencies from the requests the
            # plans actually made (prefetch mode predicts them instead)
            with self._cache_lock:
                for s in range(self.num_shards):
                    self._cache_policy.observe(s, plan.remote_ids[s])
        if self._uploader is not None:
            # async pipeline: commit the upload here, on the prefetch
            # thread, so plan i+1's transfer overlaps plan i's execution
            with obs_span("upload.commit", track="uploader",
                          epoch=epoch, it=it):
                self._uploader.commit(plan)
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
            hot = self._cache_prefetcher.epoch_requests(epoch, iters)
            with self._cache_lock:
                sel = [self._cache_policy.select(s, self.cache_rows,
                                                 hot_ids=ids, hot_counts=cnt)
                       for s, (ids, cnt) in enumerate(hot)]
            rows = [self._features_of(ids) for ids in sel]
            return sel, rows

    def _cache_epoch_begin(self, epoch: int, epochs: int, iters: int,
                           batch_per_model: int, cache_exec) -> float:
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
            elif epoch == 0 and self._cache_policy.static:
                # degree policy: one static selection, installed before the
                # first plan and never refreshed
                self._cache_select_install()
            elif not self._cache_policy.static and cache_exec is None \
                    and epoch > 0:
                # trailing LFU (prefetch off): select from frequencies
                # observed in earlier epochs' plans
                self._cache_select_install()
            if cache_exec is not None and not self._cache_policy.static \
                    and epoch + 1 < epochs:
                self._cache_fut = cache_exec.submit(self._cache_compute,
                                                    epoch + 1, iters)
            # upload now, so it lands in cache_refresh_s and not inside the
            # first (steady-timed) step of the epoch
            self.cache_store.device_table
            return time.perf_counter() - t0

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
        return engine.empty_cache_table(self.num_shards,
                                        self.store.feature_dim,
                                        self.table.dtype, self.device)

    def train_step(self, plan: IterationPlan):
        """Grads, then the optimizer update as a separate call (the
        ``fused=False`` path). Returns the device loss."""
        cache_tab = self._cache_table_for(plan)
        grads, loss = engine.run_iteration(self.params, self.table, plan,
                                           self.cfg, cache=cache_tab,
                                           fold_returns=self.fold_returns)
        self.params, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params)
        self.global_step += 1
        return loss

    def _dispatch_fused(self, plan: IterationPlan):
        """One fused call: iteration + optimizer update. Returns the
        *device* loss — no host sync happens here."""
        cache_tab = self._cache_table_for(plan)
        fn = engine.get_compiled_train_step(
            self.cfg, plan.pregather, self.optimizer,
            fold_returns=engine.resolve_fold_returns(plan,
                                                     self.fold_returns))
        table, cache_tab, dev, denom = engine.prepare_iteration_args(
            self.table, plan, cache_tab)
        self.params, self.opt_state, loss = fn(
            self.params, self.opt_state, table, cache_tab, dev, denom)
        self.global_step += 1
        return loss

    def _dispatch_stacked(self, plans: Sequence[IterationPlan]):
        """One call covering ``len(plans)`` same-bucket iterations
        (pipeline_stack > 1). Returns the (K,) device losses."""
        p0 = plans[0]
        for p in plans[1:]:
            if (p.pregather != p0.pregather
                    or p.cache_version != p0.cache_version
                    or p.num_steps != p0.num_steps):
                raise ValueError("stacked plans must share mode, cache "
                                 "version, and merge pattern")
            if (p.batch_pad, p.r_max, p.c_max) != \
                    (p0.batch_pad, p0.r_max, p0.c_max):
                # a mid-epoch budget re-bucket split the group's shapes:
                # dispatch one by one (one new signature, as unstacked)
                return torch.stack([self._dispatch_fused(q) for q in plans])
        cache_tab = self._cache_table_for(p0)
        fn = engine.get_compiled_train_step(
            self.cfg, p0.pregather, self.optimizer,
            fold_returns=engine.resolve_fold_returns(p0, self.fold_returns),
            stacked=True)
        devs, denoms = stack_committed(plans, self.device)
        self.params, self.opt_state, losses = fn(
            self.params, self.opt_state, self.table, cache_tab, devs,
            denoms)
        self.global_step += len(plans)
        return losses

    def _dispatch(self, plans: Sequence[IterationPlan]):
        """The dispatch both epoch loops use."""
        if len(plans) > 1:
            return self._dispatch_stacked(plans)
        if self.fused:
            return self._dispatch_fused(plans[0])
        return self.train_step(plans[0])

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
        for it in range(iters):
            with obs_span("plan.wait", epoch=epoch, it=it):
                plan = fut.result()
            if it + 1 < iters:
                # double-buffer: plan i+1 builds while i executes
                fut = submit(self.build_plan, epoch, it + 1,
                             batch_per_model)
            tc0 = engine.trace_count()
            t0 = time.perf_counter()
            with obs_span("dispatch", epoch=epoch, it=it):
                loss = self._dispatch([plan])
            with obs_span("loss.sync", epoch=epoch, it=it):
                losses.append(float(loss))   # waits for the device
            iter_times.append(time.perf_counter() - t0)
            traced.append(engine.trace_count() > tc0)
            remote += plan.remote_rows_exact
            cache_hits += plan.cache_hit_rows
            num_steps = plan.num_steps
        steady = [t for t, tr in zip(iter_times, traced) if not tr]
        return EpochRunResult(
            losses=losses, wall_s=time.perf_counter() - t_epoch,
            steady_iter_s=float(np.mean(steady)) if steady else None,
            dispatch_s=0.0, traces=int(sum(traced)), remote_rows=remote,
            cache_hit_rows=cache_hits, num_steps=num_steps)

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
        controller."""
        if resume:
            raise _not_ported("resume", "2, checkpoints")
        stats: list[EpochStats] = []
        pool = (ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix="prefetch")
                if self._prefetch else None)
        submit = pool.submit if pool is not None else self._run_inline
        if self.pipeline and self._uploader is None:
            self._uploader = PlanUploader(budget=self.budget,
                                          device=self.device)
        # the cache refresh computation gets its own thread: it must not
        # block the plan double-buffer (and vice versa)
        cache_exec = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="cache")
                      if (self.cache_enabled and self.cache_prefetch
                          and not self._cache_policy.static) else None)
        try:
            for epoch in range(epochs):
                refresh_s = self._cache_epoch_begin(
                    epoch, epochs, iters_per_epoch, batch_per_model,
                    cache_exec)
                if self.pipeline:
                    res = run_pipelined_epoch(
                        self, epoch, iters_per_epoch, batch_per_model,
                        submit, stack=self.pipeline_stack,
                        loss_sync_iters=self.loss_sync_iters)
                else:
                    res = self._epoch_sync(epoch, iters_per_epoch,
                                           batch_per_model, submit)
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
                    dispatch_s=res.dispatch_s)
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
                        + ("" if st.compile_free else " (all-compile)")
                        + (f" acc {100 * acc:.1f}%" if acc is not None
                           else ""))
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
            if cache_exec is not None:
                cache_exec.shutdown(wait=False, cancel_futures=True)
                self._cache_fut = None
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
