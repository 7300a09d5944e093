"""Thread supervision + the graceful-degradation policy ladder.

The port of ``repro.resilience.supervisor``. The Trainer runs background
work on threads: the plan prefetcher, the ``PlanUploader`` commits riding
on it, and the cache-refresh thread (the streamed store's readahead
forecast joins them with streamed training). Unsupervised, an exception on
any of them surfaces only when (and if) its future is ``.result()``-ed —
the cache thread's an *epoch* late, an abandoned prefetch future's never —
and a stalled thread wedges the loop forever.

:class:`ThreadSupervisor` fixes the observability half: every submission is
wrapped so the executing thread records failures *at raise time* with the
originating job's ``(site, epoch, it)`` context, and the training loop
calls :meth:`check` at each dispatch boundary, turning a silent background
death into a prompt, attributable :class:`BackgroundError`. The wrapper
also publishes the site through ``faults.current_site`` so injected
thread faults know which thread they are on.

The degradation half is a policy ladder, applied by the Trainer when a
recoverable error survives an in-mode replay (see loop.py ``_recover``):

  1. prefetch/uploader failure or stall  → pipeline → synchronous fused
     loop with inline planning (bit-identical: both loops run the same
     operations in the same order);
  2. cache-thread failure                → cache-on → cache-off
     (bit-identical: a cache hit reads the same row a fetch would);
  3. readahead / storage failure         → streamed hot-tier → resident
     gather straight from the authoritative backing tier. This rung needs
     the streamed store, which the port's Trainer does not run yet
     (ROADMAP Queue 1 item 10).

Every rung preserves bit-exactness, only costs throughput — which is what
lets the chaos-parity tests demand identical losses under every fault
class. Each step taken is logged into ``EpochStats.degradations``.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from repro_torch.resilience.comm import RetryPolicy
from repro_torch.resilience import faults as _faults

import dataclasses


class BackgroundError(RuntimeError):
    """A background thread failed; carries the originating job context."""

    def __init__(self, site: str, epoch: int, it: int,
                 cause: BaseException):
        super().__init__(
            f"background {site} job for (epoch {epoch}, it {it}) failed: "
            f"{type(cause).__name__}: {cause}")
        self.site = site
        self.epoch = epoch
        self.it = it
        self.__cause__ = cause


class StallError(RuntimeError):
    """A background job missed its deadline (stalled thread / straggler)."""

    def __init__(self, site: str, epoch: int, it: int, deadline_s: float):
        super().__init__(
            f"background {site} job for (epoch {epoch}, it {it}) exceeded "
            f"its {deadline_s}s deadline")
        self.site = site
        self.epoch = epoch
        self.it = it


class NonFiniteLoss(RuntimeError):
    """NaN/Inf detected on the loss-sync window."""

    def __init__(self, epoch: int, it: int, value: float):
        super().__init__(
            f"non-finite loss {value!r} at (epoch {epoch}, it {it})")
        self.site = "loss"
        self.epoch = epoch
        self.it = it
        self.value = value


class CheckpointRollbackExhausted(RuntimeError):
    """NaN persisted across ``max_rollbacks`` replay attempts — genuine
    divergence, not a transient; surfaced to the caller."""


@dataclasses.dataclass
class ResiliencePolicy:
    """What the Trainer is allowed to do about failures.

    The default policy is cheap enough to be always-on: one params/opt
    tree copy per epoch (the rollback snapshot), a deque peek per
    iteration (the supervisor check), and an ``isfinite`` on each synced
    loss window.
    """

    enabled: bool = True
    guard_nonfinite: bool = True     # NaN/Inf loss -> rollback + replay
    degrade: bool = True             # allow the policy ladder (else replay
    #                                  in-mode only, then escalate)
    max_rollbacks: int = 2           # NaN rollbacks per fit() before escalating
    max_epoch_attempts: int = 5      # total tries per epoch (1 clean +
    #                                  replays/degradations)
    stall_deadline_s: Optional[float] = 60.0   # plan-future wait deadline
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    # -- membership (repro_torch.membership): what to do about a *peer* dying.
    # A peer-attributed CommTimeout triggers a bounded liveness re-probe;
    # a confirmed death recovers per membership_mode: "rejoin" (replacement
    # worker takes the dead rank — bit-identical resume), "redistribute"
    # (survivors split the lost shard's vertices — elastic shrink, new
    # numerics), or "adopt" (one survivor takes the whole shard).
    membership: bool = True
    membership_mode: str = "rejoin"
    probe_attempts: int = 3          # liveness probes before confirming death
    probe_backoff_s: float = 0.001   # sleep between probes

    @classmethod
    def resolve(cls, value) -> Optional["ResiliencePolicy"]:
        """Trainer ctor coercion: None/True -> default policy, False ->
        disabled (None), a policy instance passes through."""
        if value is None or value is True:
            return cls()
        if value is False:
            return None
        if isinstance(value, cls):
            return value if value.enabled else None
        raise TypeError(f"resilience must be a ResiliencePolicy or bool, "
                        f"got {type(value)!r}")


class ThreadSupervisor:
    """Records background failures at raise time; re-raises at boundaries.

    ``submit(submitter, site, fn, *args, epoch=, it=)`` wraps ``fn`` so the
    worker thread (a) publishes its site for fault injection, (b) records
    any exception with full context into the pending deque, and (c) still
    raises — so a consumer blocking on the future sees the same wrapped
    :class:`BackgroundError` that :meth:`check` would surface. Whichever
    boundary fires first delivers the error exactly once.
    """

    def __init__(self):
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self.errors_recorded = 0

    def submit(self, submitter: Callable, site: str, fn: Callable, *args,
               epoch: int = -1, it: int = -1):
        def run():
            token = _faults.current_site.set(site)
            try:
                return fn(*args)
            except BackgroundError:
                raise                    # already wrapped + recorded upstream
            except BaseException as e:
                err = BackgroundError(site, epoch, it, e)
                self._record(err)
                raise err from e
            finally:
                _faults.current_site.reset(token)
        return submitter(run)

    def _record(self, err: BackgroundError) -> None:
        with self._lock:
            self._pending.append(err)
            self.errors_recorded += 1

    def check(self) -> None:
        """Raise the earliest pending background error (iteration-boundary
        call). No-op when healthy; each error is delivered at most once."""
        if not self._pending:            # lock-free fast path (GIL-atomic)
            return
        with self._lock:
            if not self._pending:
                return
            err = self._pending.popleft()
        raise err

    def mark_delivered(self, err: BaseException) -> None:
        """A future's ``.result()`` already delivered ``err`` to the loop —
        drop the matching pending record so check() won't double-raise."""
        with self._lock:
            try:
                self._pending.remove(err)
            except ValueError:
                pass

    def drain(self) -> list:
        """Clear and return everything pending (recovery path: abandoned
        futures' errors must not leak into the next epoch attempt)."""
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
        return out
