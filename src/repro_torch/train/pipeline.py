"""Async device pipeline: keep the device fed.

The port of ``repro.train.pipeline``. Four cooperating pieces:

* **Fused dispatch** — the Trainer steps through
  ``repro_torch.core.distributed.get_compiled_train_step``: iteration +
  optimizer update in one call, the update in place on the parameters and
  moments (the reference's donation). No gradients travel back to the
  loop.
* **Non-blocking loop** (:func:`run_pipelined_epoch`) — PyTorch queues
  device work and returns, so losses stay on the device until the epoch
  boundary and the host races ahead building and uploading plans while the
  device executes. Backpressure: every ``loss_sync_iters`` dispatches
  (Trainer default 16; 0 disables) the loop waits for the device, bounding
  how many queued iterations — each holding its committed plan buffers —
  can pile up.
* **Plan upload off the critical path** (:class:`PlanUploader`) — the plan
  prefetch thread copies plan i+1's device args to the card while plan i
  executes and stamps the plan (``plan.committed``), so the engine's
  argument fast path skips the upload. Every array of the plan's device
  args goes this way, a streamed plan's feature blocks (``feat_local``,
  ``feat_fetch``: the largest upload of all) included. On CUDA the arrays
  are staged in pinned host memory and copied with ``non_blocking=True``
  on a side stream (a non-blocking copy from pageable memory would be
  synchronous and end the overlap); an event recorded after the copies is
  what the compute stream waits on at dispatch, where each committed tensor
  is also marked as used on the compute stream (``record_stream``), so the
  caching allocator never hands its memory to a later upload while the
  device still reads it. The staging blocks come from PyTorch's
  pinned-memory allocator, which records the copy on the side stream and
  does not reuse a block until that copy is done. Every plan's shapes are
  checked against its ShapeBudget bucket (a shape change would mean a new
  signature), and a plan stamped under an older membership generation is
  refused before anything is staged. When an epoch is abandoned mid-flight
  (a fault), :meth:`PlanUploader.drain` waits for the side stream's last
  copy before the replay reuses or drops the uploader.
* **K-stacking** (optional, ``pipeline_stack=K``) — K same-bucket plans
  go to the fused step in one call, which loops over them.

Timing semantics: per-iteration wall times in the pipelined loop are
*dispatch* times — the device has not necessarily finished when the call
returns. Steady-state time is measured on a synced window: the epoch's
dispatch loop runs free, a CUDA event synchronize closes the window, and
the window wall over its iteration count is the steady per-iteration
estimate. Whenever a dispatch has a new shape signature, the window
restarts *after* a sync, so the estimate stays free of first-call costs
and the §5.3 merging controller gets the signal the Trainer promised it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import distributed as engine
from repro_torch.device import resolve_device
from repro_torch.obs.trace import event as obs_event, span as obs_span


class PlanUploader:
    """Host→device committer for IterationPlan device args.

    ``commit(plan)`` runs on the plan prefetch thread: it checks the plan's
    indices on the host (once per plan), uploads its device-args tree and
    the float32 denom scalar, and stamps ``plan.committed = {"dev",
    "denom", "event", "shard"}`` for the engine's fast path. On CUDA the
    upload is asynchronous on the uploader's own stream (see the module
    doc); on the CPU the tensors wrap the plan's arrays and ``event`` is
    None.

    Shape discipline: within one merge pattern every upload must carry the
    same shape signature. Deviations are counted in ``shape_changes`` — a
    legitimate change exists only at an explicit budget re-bucket; with
    ``budget`` given, every committed plan is also checked against the
    ShapeBudget bucket it claims to be built under.

    Under a device mesh (``shard`` = this rank) only the rank's slice of
    every leading-N array is staged and uploaded, the shard axis kept at
    size 1, and the commit records the shard it was made for.
    """

    def __init__(self, budget=None, device=None, view=None,
                 shard: Optional[int] = None):
        self.budget = budget
        self.view = view               # MembershipView (world-stale refusal)
        self.shard = shard
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._sigs: dict = {}          # pattern (num_steps) -> signature
        self._buckets: dict = {}       # pattern -> bucket_shapes snapshot
        self.uploads = 0
        self.shape_changes = 0

    def _upload(self, plan):
        host = engine.tree_map(
            lambda x: engine.shard_slice(x, self.shard, plan.num_shards),
            plan.device_args())
        denom = torch.tensor(float(plan.global_batch), dtype=torch.float32)
        if self._stream is None:
            return engine.tree_map(lambda x: engine.upload(x, self.device),
                                   host), denom, None
        with torch.cuda.device(self.device):
            staged = engine.tree_map(
                lambda x: torch.from_numpy(np.ascontiguousarray(x))
                .pin_memory(), host)
            denom = denom.pin_memory()
            with torch.cuda.stream(self._stream):
                dev = engine.tree_map(
                    lambda t: t.to(self.device, non_blocking=True), staged)
                denom = denom.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
        return dev, denom, event

    def drain(self) -> None:
        """Wait until every copy issued on the side stream is done (a CUDA
        synchronize of that stream alone; nothing to wait for on the
        CPU)."""
        if self._stream is not None:
            self._stream.synchronize()

    def commit(self, plan) -> None:
        if self.view is not None:
            # refuse to stage a dead world's bytes: a plan stamped under an
            # older membership generation must not commit (the dispatch
            # boundary re-checks, but the upload is the first place stale
            # buffers would be staged)
            ei = getattr(plan, "epoch_it", (-1, -1))
            self.view.check_generation(getattr(plan, "generation", -1),
                                       epoch=ei[0], it=ei[1])
        expect = None
        if self.budget is not None:
            expect = self.budget.bucket_shapes(plan.num_steps)
            if expect is not None:
                bp, rm, cm, lm = expect
                if (plan.batch_pad, plan.r_max) != (bp, rm) \
                        or plan.c_max not in (0, cm) \
                        or plan.l_max not in (0, lm):
                    raise AssertionError(
                        f"plan shapes ({plan.batch_pad}, {plan.r_max}, "
                        f"{plan.c_max}, {plan.l_max}) drifted from budget "
                        f"bucket ({bp}, {rm}, {cm}, {lm}) for pattern "
                        f"{plan.num_steps}")
        engine.check_plan_indices(plan)
        dev, denom, event = self._upload(plan)
        sig = engine._shape_sig(dev)
        key = plan.num_steps
        prev = self._sigs.get(key)
        if prev is not None and prev != sig \
                and self._buckets.get(key) == expect:
            # not an explicit budget re-bucket (that one is expected, and
            # counted by the engine's trace log): a stability violation
            self.shape_changes += 1
        self._sigs[key] = sig
        self._buckets[key] = expect
        plan.committed = {"dev": dev, "denom": denom, "event": event,
                          "shard": self.shard}
        self.uploads += 1


def stack_committed(plans, device: torch.device,
                    shard: Optional[int] = None):
    """K plans' device args for the stacked fused step: a list of their
    trees (committed ones as uploaded, others checked and uploaded now —
    with ``shard``, that shard's slices) and their denoms stacked into a
    (K,) tensor."""
    args = [engine.plan_device_args(p, device, shard) for p in plans]
    return [dev for dev, _ in args], torch.stack([d for _, d in args])


@dataclasses.dataclass
class EpochRunResult:
    """What one epoch's iteration loop hands back to Trainer.fit —
    produced by both the pipelined loop here and the Trainer's synchronous
    loop, so fit() assembles EpochStats identically for both."""

    losses: List[float]          # per-iteration losses, in order
    wall_s: float                # dispatch-loop wall incl. final sync
    steady_iter_s: Optional[float]   # trace-free synced-window estimate
    #                                  (None: every window contained a trace)
    dispatch_s: float            # host time spent inside dispatch calls
    traces: int                  # engine trace-log delta over the epoch
    remote_rows: int
    cache_hit_rows: int
    num_steps: int
    # --- streamed feature path (repro_torch.features; zeros when resident)
    tier1_rows: int = 0          # host hot-tier rows served to plan gathers
    tier2_rows: int = 0          # backing/mmap rows served (hot-tier misses)
    upload_bytes: int = 0        # plan-carried feature bytes shipped


def run_pipelined_epoch(trainer, epoch: int, iters: int,
                        batch_per_model: int, submit: Callable,
                        stack: int = 1,
                        loss_sync_iters: int = 0) -> EpochRunResult:
    """One epoch of non-blocking fused dispatch.

    ``submit(fn, *args)`` is the Trainer's plan-prefetch submitter (thread
    pool or inline). Up to ``stack + 1`` plan builds are kept in flight so
    a K-stacked dispatch never starves; each build commits its device
    upload on the prefetch thread (PlanUploader), overlapping the transfer
    with device execution of the previous dispatch. Plan waits go through
    the Trainer's stall deadline, dispatches through its guarded
    ``_dispatch``, and each synced loss window through its NaN/Inf guard.
    When the epoch fails, the builds still in flight are abandoned through
    the Trainer (the replay rebuilds them).
    """
    futs: deque = deque()          # (it, future) pairs, in order
    try:
        return _pipelined_epoch(trainer, epoch, iters, batch_per_model,
                                submit, stack, loss_sync_iters, futs)
    except BaseException as e:
        trainer._abandon([fut for _, fut in futs], e)
        raise


def _pipelined_epoch(trainer, epoch, iters, batch_per_model, submit, stack,
                     loss_sync_iters, futs) -> EpochRunResult:
    K = max(1, int(stack))
    tc_start = engine.trace_count()
    t_epoch = time.perf_counter()

    next_it = 0
    done = 0

    def top_up(minimum: int = 0) -> None:
        nonlocal next_it
        while next_it < iters and (len(futs) < K + 1
                                   or next_it < done + minimum):
            futs.append((next_it, submit(trainer.build_plan, epoch,
                                         next_it, batch_per_model)))
            next_it += 1

    top_up(minimum=1)
    raw_losses: list = []
    remote = hits = 0
    t1 = t2 = up = 0
    num_steps = 0
    dispatch_s = 0.0
    window_t: Optional[float] = None
    window_iters = 0
    steady: Optional[float] = None
    since_sync = 0
    while done < iters:
        k = min(K, iters - done)
        top_up(minimum=k)
        plans = []
        for _ in range(k):
            it_i, fut = futs.popleft()
            with obs_span("plan.wait", epoch=epoch, it=it_i):
                plans.append(trainer._plan_result(fut, epoch, it_i))
        top_up()
        if window_t is None:
            # the window opens at the first dispatch, after the (serial)
            # first plan build — plan waits *inside* the window are real
            # pipeline stalls and belong in the steady estimate
            window_t = time.perf_counter()
        tc0 = engine.trace_count()
        td0 = time.perf_counter()
        # guarded dispatch: a stale-world plan is refused, pending
        # background errors surface here, and transient comm faults retry
        # during argument staging, before the in-place update
        with obs_span("dispatch", epoch=epoch, it=done):
            loss = trainer._dispatch(plans, epoch, done)
        dispatch_s += time.perf_counter() - td0
        raw_losses.append(loss)
        for p in plans:
            remote += p.remote_rows_exact
            hits += p.cache_hit_rows
            if p.tier_stats:
                t1 += p.tier_stats["tier1_rows"]
                t2 += p.tier_stats["tier2_rows"]
                up += p.tier_stats["upload_bytes"]
        num_steps = plans[-1].num_steps
        done += k
        since_sync += k
        if engine.trace_count() > tc0:
            # this dispatch had a new shape signature: drain the queue and
            # restart the steady window after the sync so first-call costs
            # never leak into the merging controller's signal
            obs_event("pipeline.retrace", epoch=epoch, it=done - 1)
            with obs_span("trace.sync", epoch=epoch, it=done - 1):
                engine.block_until_ready(trainer.device)
            window_t = time.perf_counter()
            window_iters = 0
        else:
            window_iters += k
        if loss_sync_iters and since_sync >= loss_sync_iters:
            with obs_span("loss.sync", epoch=epoch, it=done - 1):
                engine.block_until_ready(trainer.device)  # queue throttle
            # deferred-loss NaN/Inf guard: this window's loss is final now
            # — divergence is detected here, not an epoch later
            trainer._check_finite(loss, epoch, done - 1)
            since_sync = 0
    with obs_span("loss.sync", epoch=epoch, it=iters - 1, boundary=True):
        engine.block_until_ready(trainer.device)
    t_end = time.perf_counter()
    if window_iters:
        steady = (t_end - window_t) / window_iters
    losses = torch.cat([torch.atleast_1d(l) for l in raw_losses]
                       ).cpu().tolist()
    return EpochRunResult(losses=losses, wall_s=t_end - t_epoch,
                          steady_iter_s=steady, dispatch_s=dispatch_s,
                          traces=engine.trace_count() - tc_start,
                          remote_rows=remote, cache_hit_rows=hits,
                          num_steps=num_steps, tier1_rows=t1, tier2_rows=t2,
                          upload_bytes=up)
