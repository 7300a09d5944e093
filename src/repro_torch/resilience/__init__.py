"""repro_torch.resilience — fault injection, supervised recovery,
degradation (the port of ``repro.resilience``).

The training stack is deterministic end to end: plans and sampling are a
pure function of ``(epoch, it, seeds, pattern, cache_version)``, every
pipeline/cache mode is bit-identical to its fallback, and shape budgets
persist across restarts. This package turns that determinism into fault
tolerance:

* :mod:`~repro_torch.resilience.faults` — a seeded :class:`FaultPlan`
  harness that injects stragglers, dropped exchanges, background-thread
  deaths, peer deaths and NaN steps at scheduled ``(epoch, it)`` points
  (plus :class:`ChaosPlan`, transient-only background chaos).
* :mod:`~repro_torch.resilience.supervisor` — :class:`ThreadSupervisor`
  (thread failures surface at the next dispatch boundary with the
  originating ``(epoch, it)`` attached), :class:`ResiliencePolicy`, and
  the degradation ladder contract (every rung bit-identical).
* :mod:`~repro_torch.resilience.comm` — deadline + bounded-retry +
  jittered exponential backoff around the host comm boundary, with
  per-epoch counters and peer attribution on timeouts (the membership
  layer's death-suspicion signal — see repro_torch.membership).

Recovery invariant: under a recoverable FaultPlan training completes with
losses and parameters bit-identical to the fault-free run, with zero
steady-state retraces.
"""
from repro_torch.core.distributed import PeerDeadError
from repro_torch.resilience.comm import (CommCounters, CommTimeout,
                                         RetryPolicy, backoff_schedule,
                                         resilient_call)
from repro_torch.resilience.faults import (CHAOS_KINDS, ChaosPlan, FaultPlan,
                                           FaultSpec, InjectedFault,
                                           InjectedThreadError,
                                           TransientCommError, active_plan)
from repro_torch.resilience.supervisor import (BackgroundError,
                                               CheckpointRollbackExhausted,
                                               NonFiniteLoss,
                                               ResiliencePolicy, StallError,
                                               ThreadSupervisor)

__all__ = [
    "FaultPlan", "FaultSpec", "ChaosPlan", "CHAOS_KINDS", "active_plan",
    "InjectedFault", "InjectedThreadError", "TransientCommError",
    "PeerDeadError",
    "RetryPolicy", "CommCounters", "CommTimeout", "resilient_call",
    "backoff_schedule",
    "ThreadSupervisor", "BackgroundError", "StallError", "NonFiniteLoss",
    "ResiliencePolicy", "CheckpointRollbackExhausted",
]
