"""repro_torch.membership — elastic membership for feature-centric
training (the port of ``repro.membership``).

Survive the death of a *peer shard*: LeapGNN pins features to workers, so
a dead peer takes a slice of the data plane with it. Three layers:

* **Detection** (:mod:`.detector`): the ``resilient_call`` deadline
  attributes a ``CommTimeout`` to a peer (``peer_of``); a bounded
  :class:`PeerProbe` separates a real death from a flap.
* **View** (:mod:`.view`): :class:`MembershipView` tracks per-shard
  liveness and an epoch-stamped **generation**; plans are stamped with the
  generation they were built under and :class:`StaleGeneration` refuses
  old-world plans at dispatch and upload boundaries.
* **Re-ownership** (:mod:`.recovery`): :func:`rebuild_world` computes the
  survivors' new ``part``/``owner``/``local_idx`` deterministically; the
  Trainer rebuilds its feature table, caches and uploader against it and
  resumes from the shared crash-atomic checkpoint. Same-world-size rejoin
  is bit-identical to the fault-free run; elastic shrink is held to a
  loss tolerance.
"""
from repro_torch.membership.detector import PeerProbe, ProbeResult, peer_of
from repro_torch.membership.recovery import WorldRebuild, rebuild_world
from repro_torch.membership.view import MembershipView, StaleGeneration

__all__ = [
    "MembershipView", "StaleGeneration",
    "PeerProbe", "ProbeResult", "peer_of",
    "WorldRebuild", "rebuild_world",
]
