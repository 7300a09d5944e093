"""Deterministic, seeded fault injection for the training stack.

The port of ``repro.resilience.faults``; the engine hook installs on
:mod:`repro_torch.core.distributed`.

The whole recovery story of :mod:`repro_torch.resilience` rests on one property
the rest of the repo already enforces: plans and sampling are a pure
function of ``(epoch, it, seeds, pattern, cache_version)``. A fault that is
absorbed (retried, replayed, or degraded around) therefore leaves *zero*
numerical trace — the recovered run's losses and parameters are bit-
identical to the fault-free run. This module provides the controlled way to
prove that: a :class:`FaultPlan` schedules faults at exact ``(epoch, it)``
points, the instrumented sites consult the active plan, and every fired
fault is logged so tests and benchmarks can assert both that the fault
actually happened and that it left no trace.

Fault classes (``FaultSpec.kind``):

* ``comm_delay``   — a straggling peer: the dispatch-side comm point sleeps
  ``delay_s`` before the exchange is issued. Absorbed by the pipeline (or
  by nothing — it is pure wall-clock).
* ``comm_drop``    — a dropped index/feature exchange: the comm point
  raises :class:`TransientCommError` on the first ``drops`` attempts of the
  guarded dispatch; the retry wrapper (repro_torch.resilience.comm) re-issues it
  with backoff. Only fires under a guard (``guarded_attempt`` context set),
  so unguarded engine callers degrade to a no-op instead of crashing.
* ``thread_stall`` — the target background thread sleeps ``delay_s``
  (models GC pauses / noisy neighbours on the planning host).
* ``thread_exc``   — the target background thread raises
  :class:`InjectedThreadError` (models a real bug/OOM on the prefetcher,
  uploader, or cache thread). Fires only when the executing thread's
  supervisor site context matches ``site`` — after the Trainer degrades to
  inline planning the same spec no longer matches, which is exactly how a
  persistent thread fault converges down the degradation ladder.
* ``disk_corrupt`` — scribbles deterministic garbage over feature rows in
  the FeatureStore's backing tier (and marks the chunk suspect, standing in
  for a scrubber / EIO signal). Detected by the store's crc32 verification,
  repaired from the authoritative source (repro_torch.features).
* ``nan_loss``     — poisons one training step's loss *and* parameters with
  NaN (models numerical divergence / a flipped exponent bit). Detected at
  the next loss-sync window; recovered by rollback to the epoch-start
  snapshot and deterministic replay.
* ``peer_death``   — a peer shard dies (host crash / network partition of a
  feature server, the failure mode repro_torch.membership exists for). The spec's
  ``shard`` is registered in the engine's dead-peer registry at the comm
  fault point; every subsequent dispatch raises ``PeerDeadError`` until a
  probe confirms the death and the membership layer recovers (rejoin or
  elastic re-ownership). With ``transient=True`` the peer merely *flaps*:
  the first ``drops`` attempts of a guarded dispatch raise PeerDeadError
  and the retry succeeds with no membership change (what ChaosPlan uses).

Scheduling is exact — ``(epoch, it)`` — and firing is once-only by default
(``once=True``); a replayed epoch does not re-trip its own fault, which is
what makes recovery terminate. ``once=False`` models persistent faults and
is what the degradation-ladder tests use.

One plan is active per process (``install``/``uninstall`` or the
``active()`` context manager); instrumented sites go through the module
functions :func:`fire_comm`, :func:`raise_if_thread`, :func:`sleep_point`,
:func:`take`, which are all no-ops when no plan is installed (the fast path
is one global read).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import event as _obs_event


def _mark_fired(kind: str, site: str, epoch: int, it: int) -> None:
    """Telemetry for one fired fault (repro_torch.obs): a registry counter per
    kind plus an instant mark on the current thread's timeline track, so
    a chaos run's exported trace shows exactly what was absorbed where."""
    _obs_metrics.inc("faults.fired")
    _obs_metrics.inc(f"faults.{kind}")
    _obs_event(f"fault.{kind}", site=site or "", epoch=epoch, it=it)


# Supervisor site of the current thread ("prefetch"/"uploader"/"cache"/
# "readahead"); set by ThreadSupervisor around background jobs. thread_exc
# faults fire only when this matches their site.
current_site: contextvars.ContextVar = contextvars.ContextVar(
    "repro_resilience_site", default=None)

# Attempt number of the current guarded dispatch (repro_torch.resilience.comm's
# resilient_call); None outside a guard. comm_drop faults fire only inside
# a guard — an unguarded caller must never see an injected raise.
guarded_attempt: contextvars.ContextVar = contextvars.ContextVar(
    "repro_resilience_attempt", default=None)


class InjectedFault(Exception):
    """Mixin marking an exception as fault-injection-originated (tests and
    the supervisor can tell injected failures from genuine bugs)."""


class TransientCommError(InjectedFault, RuntimeError):
    """A dropped/timed-out exchange that a retry may recover."""


class InjectedThreadError(InjectedFault, RuntimeError):
    """Background-thread death injected by a FaultPlan."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault. ``it < 0`` matches any iteration of ``epoch``
    (used by epoch-boundary faults like disk corruption)."""

    kind: str                 # see module docstring
    epoch: int
    it: int = -1
    site: str = ""            # thread faults: prefetch|uploader|cache|readahead
    shard: int = 0            # disk_corrupt target
    row: int = 0
    rows: int = 1             # disk_corrupt: contiguous rows scribbled
    delay_s: float = 0.0      # comm_delay / thread_stall
    drops: int = 1            # comm_drop / flapping peer_death: failing
                              # attempts before success
    once: bool = True
    transient: bool = False   # peer_death: flap (guarded raise) instead of
                              # registering a persistent kill


class FaultPlan:
    """A seeded, ordered set of :class:`FaultSpec`\\ s plus a fired log.

    ``fired`` records ``(kind, site, epoch, it)`` tuples in firing order —
    benchmarks and chaos-parity tests assert against it (that the faults
    actually fired *and* that the run recovered bit-identically anyway).
    """

    def __init__(self, specs: List[FaultSpec], seed: int = 0,
                 name: str = "faultplan"):
        self.specs = list(specs)
        self.seed = int(seed)
        self.name = name
        self.fired: list[tuple] = []
        self._spent: set[int] = set()    # indices of exhausted once-specs
        self._lock = threading.Lock()

    # -- matching ------------------------------------------------------

    def _take(self, kind: str, epoch: int, it: int,
              site: Optional[str] = None) -> List[FaultSpec]:
        """Matching specs for a fault point, marking once-specs spent and
        logging the firing. Thread-safe (sites fire from worker threads)."""
        out = []
        with self._lock:
            for i, sp in enumerate(self.specs):
                if sp.kind != kind or i in self._spent:
                    continue
                if sp.epoch != epoch:
                    continue
                if sp.it >= 0 and it >= 0 and sp.it != it:
                    continue
                if site is not None and sp.site and sp.site != site:
                    continue
                if sp.once:
                    self._spent.add(i)
                self.fired.append((sp.kind, sp.site, epoch, it))
                out.append(sp)
        for sp in out:
            _mark_fired(sp.kind, sp.site, epoch, it)
        return out

    def fired_count(self) -> int:
        with self._lock:
            return len(self.fired)

    # -- lifecycle -----------------------------------------------------

    def install(self) -> "FaultPlan":
        _set_active(self)
        return self

    def uninstall(self) -> None:
        _set_active(None, expect=self)

    @contextlib.contextmanager
    def active(self):
        prev = active_plan()          # nest inside e.g. a session ChaosPlan
        self.install()
        try:
            yield self
        finally:
            _set_active(prev, expect=self)

    # -- canonical plans ----------------------------------------------

    @classmethod
    def recoverable(cls, seed: int = 0, *, kill_epoch: int = 1,
                    nan_epoch: int = 2) -> "FaultPlan":
        """The headline-gate plan: one background-thread kill, one
        transient comm delay, one dropped exchange (retried), one corrupted
        disk chunk, and one NaN step — every one recoverable, so training
        must finish bit-identical to the fault-free run."""
        return cls([
            FaultSpec("thread_exc", epoch=kill_epoch, it=1, site="prefetch"),
            FaultSpec("comm_delay", epoch=kill_epoch, it=3, delay_s=0.003),
            FaultSpec("comm_drop", epoch=kill_epoch, it=5, drops=1),
            FaultSpec("disk_corrupt", epoch=kill_epoch, shard=0, row=0,
                      rows=2),
            FaultSpec("nan_loss", epoch=nan_epoch, it=1),
        ], seed=seed, name="recoverable")


# The chaos whitelist: every kind ChaosPlan can draw.
CHAOS_KINDS = ("comm_delay", "comm_drop", "thread_stall", "peer_death")


class ChaosPlan(FaultPlan):
    """Low-rate, transient-only background chaos for running whole test
    suites under fault pressure.

    Faults are drawn deterministically from a hash of
    ``(seed, kind, epoch, it)`` — the same run sees the same faults — and
    are restricted to classes that every code path absorbs without
    semantic effect: short comm delays, single-drop exchanges (guarded
    callers retry; unguarded callers never see drops), short planner
    stalls, and flapping peers (``peer_death`` with ``transient=True``: a
    guarded dispatch sees PeerDeadError once, the retry finds the peer
    back — the membership detector's false-positive path). No corruption,
    no thread kills, no NaNs, no *persistent* deaths: the tests' assertions
    (bit-parity, trace counts) must hold unchanged under this plan.

    ``offered`` counts how many times each kind was *consulted* (fired or
    not), so the coverage assertion can require fired > 0 only for kinds
    the suite actually exposed enough draws to.
    """

    def __init__(self, seed: int = 0, rate: float = 0.05,
                 max_delay_s: float = 0.002):
        super().__init__([], seed=seed, name=f"chaos-smoke-{seed}")
        self.rate = float(rate)
        self.max_delay_s = float(max_delay_s)
        self.offered: dict[str, int] = {k: 0 for k in CHAOS_KINDS}

    def fired_by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {k: 0 for k in CHAOS_KINDS}
        with self._lock:
            for kind, _site, _e, _i in self.fired:
                out[kind] = out.get(kind, 0) + 1
        return out

    def _hash01(self, kind: str, epoch: int, it: int) -> float:
        # splitmix64-flavoured integer hash -> [0, 1); Python ints with an
        # explicit 64-bit mask (multiplication is *meant* to wrap). The
        # kind is mixed in via crc32, NOT hash(): str hash is randomized
        # per process, which would make the chaos schedule differ between
        # runs of the same seed — the coverage assertion (tests/conftest)
        # and "same run sees the same faults" both need it stable.
        import zlib
        mask = (1 << 64) - 1
        x = ((self.seed * 0x9E3779B97F4A7C15) & mask
             ^ (zlib.crc32(kind.encode()) & 0xFFFFFFFF)
             ^ ((epoch & 0xFFFF) << 32)
             ^ (it & 0xFFFFFFFF))
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
        x = x ^ (x >> 31)
        return x / 2**64

    def _take(self, kind: str, epoch: int, it: int,
              site: Optional[str] = None) -> List[FaultSpec]:
        if kind not in CHAOS_KINDS:
            return []
        with self._lock:
            self.offered[kind] = self.offered.get(kind, 0) + 1
        u = self._hash01(kind, epoch, it)
        # drops and flaps raise (absorbed only by guarded retries) — keep
        # them rarer than the pure-wall-clock delays/stalls
        thresh = self.rate * (0.5 if kind in ("comm_drop", "peer_death")
                              else 1.0)
        if u >= thresh:
            return []
        sp = FaultSpec(kind, epoch=epoch, it=it, site=site or "",
                       delay_s=(u / max(thresh, 1e-12)) * self.max_delay_s,
                       drops=1, once=False,
                       transient=(kind == "peer_death"))
        with self._lock:
            self.fired.append((kind, site or "", epoch, it))
        _mark_fired(kind, site or "", epoch, it)
        return [sp]


# ---------------------------------------------------------------------------
# Active-plan registry + instrumented fault points
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None
_ACTIVE_LOCK = threading.Lock()


def _set_active(plan: Optional[FaultPlan],
                expect: Optional[FaultPlan] = None) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        if expect is not None and _ACTIVE is not expect:
            return            # someone else's plan is active; leave it
        _ACTIVE = plan
    # keep the engine's host-boundary comm hook in sync (lazy import keeps
    # repro_torch.core free of any resilience dependency)
    from repro_torch.core import distributed as engine
    engine.set_comm_fault_hook(None if plan is None else _engine_comm_hook)


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def _epoch_it_of(plan_obj) -> tuple[int, int]:
    ei = getattr(plan_obj, "epoch_it", None)
    return (int(ei[0]), int(ei[1])) if ei is not None else (-1, -1)


def _engine_comm_hook(plan_obj) -> None:
    """Installed into repro_torch.core.distributed's host comm boundary: every
    iteration dispatch staging exchange arguments passes through here."""
    epoch, it = _epoch_it_of(plan_obj)
    fire_comm(epoch, it)


def fire_comm(epoch: int, it: int) -> None:
    """Comm fabric fault point (dispatch-side, before any in-place update).

    Delays sleep in place; drops raise :class:`TransientCommError` but only
    inside a guarded dispatch (``guarded_attempt`` set) and only while the
    attempt number is below the spec's ``drops`` — a retry always succeeds
    eventually, and unguarded callers only ever see the sleep."""
    fp = _ACTIVE
    if fp is None:
        return
    for sp in fp._take("comm_delay", epoch, it):
        time.sleep(sp.delay_s)
    attempt = guarded_attempt.get()
    for sp in fp._take("comm_drop", epoch, it):
        if attempt is not None and attempt < sp.drops:
            raise TransientCommError(
                f"injected drop of exchange at (epoch {epoch}, it {it}), "
                f"attempt {attempt}")
    for sp in fp._take("peer_death", epoch, it):
        from repro_torch.core import distributed as engine
        if sp.transient:
            # flapping peer: unreachable for the first ``drops`` guarded
            # attempts, back before the probe would confirm anything.
            # Unguarded callers never see the raise (same contract as
            # comm_drop) — the membership layer must treat a recovered
            # flap as a non-event.
            if attempt is not None and attempt < sp.drops:
                raise engine.PeerDeadError(
                    f"injected peer flap: shard {sp.shard} unreachable at "
                    f"(epoch {epoch}, it {it}), attempt {attempt}",
                    peer=sp.shard)
        else:
            # persistent death: register the kill; the enclosing
            # comm_fault_point consults the registry right after the hook
            # returns, so this same dispatch fails with the peer attributed
            engine.kill_peer(sp.shard)


def sleep_point(kind_site: str, epoch: int, it: int) -> None:
    """Stall fault point (prefetcher/planner): sleeps if a thread_stall is
    scheduled here. Safe from any thread, inline or pooled."""
    fp = _ACTIVE
    if fp is None:
        return
    for sp in fp._take("thread_stall", epoch, it, site=kind_site):
        time.sleep(sp.delay_s)


def raise_if_thread(site: str, epoch: int, it: int) -> None:
    """Thread-death fault point: raises InjectedThreadError when a
    thread_exc is scheduled for this site AND the executing thread is
    actually supervised under that site (inline fallbacks don't re-trip)."""
    fp = _ACTIVE
    if fp is None or current_site.get() != site:
        return
    if fp._take("thread_exc", epoch, it, site=site):
        raise InjectedThreadError(
            f"injected {site}-thread death at (epoch {epoch}, it {it})")


def take(kind: str, epoch: int, it: int = -1) -> List[FaultSpec]:
    """Generic take for Trainer-managed fault classes (nan_loss at dispatch,
    disk_corrupt at epoch boundaries)."""
    fp = _ACTIVE
    if fp is None:
        return []
    return fp._take(kind, epoch, it)


def inject_disk_corruption(store, spec: FaultSpec) -> int:
    """Scribble deterministic garbage over ``spec.rows`` backing rows of
    ``spec.shard`` starting at ``spec.row`` and mark the chunk suspect
    (see repro_torch.features.FeatureStore.corrupt_rows). Returns rows hit."""
    rows = np.arange(spec.row, spec.row + max(1, spec.rows), dtype=np.int64)
    rows = rows[rows < store.local_rows]
    if rows.size:
        store.corrupt_rows(spec.shard, rows, seed=active_seed())
    return int(rows.size)


def active_seed() -> int:
    return _ACTIVE.seed if _ACTIVE is not None else 0
