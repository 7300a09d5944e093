"""Peer-death detection: timeout attribution + bounded liveness probing.

The port of ``repro.membership.detector``.

Detection is two-phase, because the comm deadline alone cannot tell a
dead peer from a long straggler or a flapping link:

1. **Suspicion** — ``resilient_call`` exhausts its retries against the
   dispatch boundary and raises ``CommTimeout``; when the underlying
   transient named a peer (the engine's ``PeerDeadError.peer``), the
   timeout carries it. :func:`peer_of` extracts that attribution from an
   exception chain.
2. **Confirmation** — :class:`PeerProbe` re-probes the suspect a bounded
   number of times with a short backoff. In this single-process harness
   the probe consults the engine's dead-peer registry (a real deployment
   would open a fresh health-check channel); a peer that answers any probe
   is a false positive and the suspicion is cleared with zero numerical
   trace — the ChaosPlan's flapping ``peer_death`` exercises exactly that
   path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.obs.trace import span as _obs_span


def peer_of(exc: BaseException) -> int:
    """Best-effort peer attribution for a failure: the first ``peer >= 0``
    found walking the exception and its cause/context chain; -1 when no
    peer was named (a generic timeout — not membership's business)."""
    seen: set[int] = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        p = getattr(e, "peer", None)
        if isinstance(p, int) and p >= 0:
            return p
        e = e.__cause__ if e.__cause__ is not None else e.__context__
    return -1


@dataclasses.dataclass
class ProbeResult:
    alive: bool
    attempts: int
    elapsed_s: float


class PeerProbe:
    """Bounded re-probe of a suspect peer.

    ``probe_fn(shard) -> bool`` answers one liveness check; the default
    consults the engine's dead-peer registry. ``confirm`` returns
    ``alive=True`` as soon as any probe answers (flap → false positive),
    ``alive=False`` after ``attempts`` consecutive silent probes."""

    def __init__(self, probe_fn: Optional[Callable[[int], bool]] = None,
                 *, attempts: int = 3, backoff_s: float = 0.001):
        if probe_fn is None:
            from repro_torch.core import distributed as engine
            probe_fn = lambda s: not engine.peer_is_dead(s)  # noqa: E731
        self.probe_fn = probe_fn
        self.attempts = max(1, int(attempts))
        self.backoff_s = float(backoff_s)

    def confirm(self, shard: int) -> ProbeResult:
        t0 = time.perf_counter()
        with _obs_span("membership.probe", shard=int(shard)):
            for attempt in range(1, self.attempts + 1):
                if self.probe_fn(shard):
                    return ProbeResult(True, attempt,
                                       time.perf_counter() - t0)
                if attempt < self.attempts:
                    time.sleep(self.backoff_s)
        return ProbeResult(False, self.attempts, time.perf_counter() - t0)
