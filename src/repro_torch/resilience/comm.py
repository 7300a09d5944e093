"""Comm robustness: deadline + bounded-retry + jittered-backoff guards.

The port of ``repro.resilience.comm``.

In a real multi-host deployment every ``ShardComm`` all_to_all is an RPC
fan-out that can drop, stall, or time out; in this repo's single-process
harness those exchanges are staged at one host boundary — the iteration
dispatch (``repro_torch.core.distributed.prepare_iteration_args`` /
``comm_fault_point``). :func:`resilient_call` wraps that boundary: the
wrapped callable is attempted up to ``1 + max_retries`` times under a total
deadline, transient failures (:class:`TransientCommError`, and
``PeerDeadError`` — a possibly-flapping peer) back off exponentially with
decorrelation jitter between attempts, and every retry/timeout lands in a
per-epoch :class:`CommCounters` that the Trainer drains into
``EpochStats``.

Backoff jitter: when one straggler stalls an iteration, *every* shard's
dispatch fails at the same instant; pure exponential backoff would re-issue
all P retries in lockstep and re-collide on the recovering fabric. Each
retry therefore sleeps ``base * (1 - jitter * u)`` where ``u ∈ [0, 1)`` is
a splitmix64 hash of ``(seed, epoch, it, attempt)`` — deterministic (a
replayed epoch sleeps the same schedule, and tests can assert it exactly
via :func:`backoff_schedule`) yet decorrelated across shards, which seed
their policies differently.

Peer attribution: a transient carrying a ``peer`` attribute (the engine's
``PeerDeadError``) stamps the eventual :class:`CommTimeout` with the last
peer seen — the signal ``repro_torch.membership`` uses to turn a timeout into a
death suspicion.

Safety with in-place updates: the engine's fused train step overwrites
the parameters and the optimizer's moments in place (the port's stand-in
for the reference's buffer donation); retrying a dispatch after the update
would apply the step twice. The guard is therefore only sound because
every injected (or real, host-side) transient raise happens *before* any
update — the comm fault point runs during argument staging, ahead of the
forward pass. A genuine failure raised by the step itself is not a
``TransientCommError`` and propagates unretried.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from repro_torch.core.distributed import PeerDeadError
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import event as _obs_event
from repro_torch.resilience.faults import (TransientCommError,
                                           guarded_attempt)


class CommTimeout(RuntimeError):
    """Retries/deadline exhausted on a transient-failing exchange.

    ``peer`` is the shard id of the last peer-attributed transient (-1 when
    no attempt named one) — the membership detector's suspicion signal."""

    def __init__(self, msg: str, *, epoch: int = -1, it: int = -1,
                 attempts: int = 0, peer: int = -1):
        super().__init__(msg)
        self.site = "comm"
        self.epoch = epoch
        self.it = it
        self.attempts = attempts
        self.peer = int(peer)


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with jittered exponential backoff under a deadline."""

    max_retries: int = 3          # attempts beyond the first
    backoff_s: float = 0.005      # sleep before attempt 1's retry
    backoff_mult: float = 2.0     # backoff_s * mult**(attempt-1)
    deadline_s: float = 5.0       # total wall budget across attempts
    jitter: float = 0.5           # fraction of each backoff randomized away
    seed: int = 0                 # decorrelation hash seed (per shard/site)


def _jitter01(seed: int, epoch: int, it: int, attempt: int) -> float:
    """splitmix64-flavoured hash of (seed, epoch, it, attempt) -> [0, 1).
    Pure: the retry schedule is a function of its coordinates, never of
    wall clock or global RNG state."""
    mask = (1 << 64) - 1
    x = ((seed * 0x9E3779B97F4A7C15) & mask
         ^ ((epoch & 0xFFFF) << 40)
         ^ ((it & 0xFFFFF) << 20)
         ^ (attempt & 0xFFFFF))
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    x = x ^ (x >> 31)
    return x / 2**64


def backoff_delay(policy: RetryPolicy, attempt: int, *, epoch: int = -1,
                  it: int = -1) -> float:
    """The exact sleep before re-issuing attempt ``attempt`` (1-based).

    ``base * (1 - jitter * u)``: full backoff at u=0, ``(1-jitter)`` of it
    at u→1 — never longer than the unjittered schedule, so deadlines tuned
    without jitter stay valid."""
    base = policy.backoff_s * policy.backoff_mult ** (attempt - 1)
    if policy.jitter <= 0.0:
        return base
    u = _jitter01(policy.seed, epoch, it, attempt)
    return base * (1.0 - policy.jitter * u)


def backoff_schedule(policy: RetryPolicy, *, epoch: int = -1, it: int = -1,
                     attempts: Optional[int] = None) -> List[float]:
    """The full sleep schedule ``resilient_call`` would take at these
    coordinates (one entry per retry). Exists so tests can pin the
    schedule without timing a live retry loop."""
    n = policy.max_retries if attempts is None else attempts
    return [backoff_delay(policy, a, epoch=epoch, it=it)
            for a in range(1, n + 1)]


@dataclasses.dataclass
class CommCounters:
    """Per-epoch exchange robustness accounting (drained into EpochStats)."""

    retries: int = 0
    timeouts: int = 0

    def reset(self) -> None:
        self.retries = 0
        self.timeouts = 0


def resilient_call(fn: Callable, *, policy: RetryPolicy,
                   counters: Optional[CommCounters] = None,
                   epoch: int = -1, it: int = -1,
                   agree: Optional[Callable[[bool], bool]] = None):
    """Run ``fn()`` under the retry policy.

    The attempt number is published via the ``guarded_attempt`` context var
    so the fault injector knows a retry loop is present (comm_drop and
    flapping peer_death faults only raise under a guard, and only while
    ``attempt < drops``).

    ``agree`` (under a device mesh, one process per shard): every rank
    retries the same attempts, but the deadline test reads each rank's own
    clock — ``agree(gave_up)`` returns whether ANY rank gives up, so all
    of them give up together or retry together and enter the same next
    collective."""
    t0 = time.perf_counter()
    attempt = 0
    peer = -1
    while True:
        token = guarded_attempt.set(attempt)
        try:
            return fn()
        except (TransientCommError, PeerDeadError) as e:
            peer = getattr(e, "peer", peer)
            if counters is not None:
                counters.retries += 1
            # every resilient_call site lands on the unified registry,
            # whether or not the caller passed per-epoch counters
            _obs_metrics.inc("comm.retries")
            _obs_event("comm.retry", epoch=epoch, it=it, attempt=attempt,
                       peer=peer)
            attempt += 1
            elapsed = time.perf_counter() - t0
            give_up = attempt > policy.max_retries \
                or elapsed > policy.deadline_s
            if agree is not None:
                give_up = agree(give_up)
            if give_up:
                if counters is not None:
                    counters.timeouts += 1
                _obs_metrics.inc("comm.timeouts")
                raise CommTimeout(
                    f"exchange failed after {attempt} attempts / "
                    f"{elapsed:.3f}s (deadline {policy.deadline_s}s): {e}",
                    epoch=epoch, it=it, attempts=attempt, peer=peer) from e
            time.sleep(backoff_delay(policy, attempt, epoch=epoch, it=it))
        finally:
            guarded_attempt.reset(token)
