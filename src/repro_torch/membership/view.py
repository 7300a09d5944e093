"""MembershipView — who is in the world, and which world is this.

The port of ``repro.membership.view``.

LeapGNN pins each worker to its vertex features, so membership is part of
the *data plane*: losing peer p means losing shard p's feature rows, and
every plan, cache entry, and prefetch built against the old world is
garbage. The view therefore carries two things:

* per-shard liveness (``alive``/``suspect``) fed by the comm deadline —
  a peer-attributed ``CommTimeout`` marks a suspect, a bounded re-probe
  (repro_torch.membership.detector) confirms or clears it;
* a monotonically increasing **generation**, bumped on every confirmed
  membership change (death-and-rejoin, elastic shrink). Plans are stamped
  with the generation they were built under and refused at the dispatch
  boundary when it no longer matches — the same version/stale-refusal
  discipline the CacheStore uses, applied to the world itself.

The view is process-local state about a shared fact: every survivor runs
the same deterministic recovery (``reassign_partition`` is a pure function
of ``(part, dead, mode)``), so equal inputs produce equal worlds without a
coordination service. Observability: the current generation is published
as the ``membership.generation`` gauge; suspicion/confirmation/rejoin
land on ``membership.suspects`` / ``membership.deaths`` /
``membership.rejoins`` counters.
"""
from __future__ import annotations

import threading
from typing import List

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import event as _obs_event


class StaleGeneration(RuntimeError):
    """A plan (or other world-stamped artifact) from an older membership
    generation reached a dispatch boundary. Recoverable: the epoch replay
    rebuilds plans under the current generation."""

    def __init__(self, msg: str, *, have: int, want: int,
                 epoch: int = -1, it: int = -1):
        super().__init__(msg)
        self.site = "membership"
        self.have = int(have)
        self.want = int(want)
        self.epoch = epoch
        self.it = it


class MembershipView:
    """World size + per-shard liveness + epoch-stamped generation."""

    def __init__(self, num_shards: int, generation: int = 0):
        self.num_shards = int(num_shards)
        self.generation = int(generation)
        self.alive: List[bool] = [True] * self.num_shards
        self._suspect: set[int] = set()
        self.epoch = -1               # epoch of the last generation bump
        self.events: list[tuple] = []  # (what, shard, generation, epoch)
        self._lock = threading.Lock()
        _obs_metrics.set_gauge("membership.generation", self.generation)

    # -- queries -------------------------------------------------------

    def is_alive(self, shard: int) -> bool:
        return 0 <= shard < self.num_shards and self.alive[shard]

    def is_suspect(self, shard: int) -> bool:
        return shard in self._suspect

    def alive_shards(self) -> list[int]:
        return [s for s in range(self.num_shards) if self.alive[s]]

    def world_size(self) -> int:
        return sum(self.alive)

    # -- transitions ---------------------------------------------------

    def mark_suspect(self, shard: int, *, epoch: int = -1,
                     it: int = -1) -> None:
        """A comm deadline expired against ``shard``: suspicion, not yet a
        membership change (no generation bump — a cleared false positive
        must leave zero trace)."""
        with self._lock:
            if shard in self._suspect or not self.is_alive(shard):
                return
            self._suspect.add(shard)
            self.events.append(("suspect", shard, self.generation, epoch))
        _obs_metrics.inc("membership.suspects")
        _obs_event("membership.suspect", shard=shard, epoch=epoch, it=it)

    def clear_suspect(self, shard: int) -> None:
        """The probe found the peer alive (a flap): forget the suspicion."""
        with self._lock:
            self._suspect.discard(shard)

    def confirm_dead(self, shard: int, *, epoch: int = -1) -> int:
        """The probe confirmed the death: mark dead and bump the
        generation. Returns the new generation; every artifact stamped
        with an older one is now stale."""
        with self._lock:
            if not self.is_alive(shard):
                return self.generation
            self.alive[shard] = False
            self._suspect.discard(shard)
            self.generation += 1
            self.epoch = epoch
            self.events.append(("dead", shard, self.generation, epoch))
            gen = self.generation
        _obs_metrics.inc("membership.deaths")
        _obs_metrics.set_gauge("membership.generation", gen)
        _obs_event("membership.dead", shard=shard, epoch=epoch,
                   generation=gen)
        return gen

    def rejoin(self, shard: int, *, epoch: int = -1) -> int:
        """A replacement worker took the dead rank (same world size):
        mark alive again under a fresh generation."""
        with self._lock:
            if self.is_alive(shard):
                return self.generation
            self.alive[shard] = True
            self.generation += 1
            self.epoch = epoch
            self.events.append(("rejoin", shard, self.generation, epoch))
            gen = self.generation
        _obs_metrics.inc("membership.rejoins")
        _obs_metrics.set_gauge("membership.generation", gen)
        _obs_event("membership.rejoin", shard=shard, epoch=epoch,
                   generation=gen)
        return gen

    def shrink(self, dead: int, *, epoch: int = -1) -> int:
        """Elastic re-ownership: the world compacts to ``num_shards - 1``
        (shard ids above ``dead`` shift down by one, matching
        ``reassign_partition``'s compaction). Fresh generation."""
        with self._lock:
            if self.num_shards < 2:
                raise ValueError("cannot shrink a 1-shard world")
            self.num_shards -= 1
            self.alive = [True] * self.num_shards
            self._suspect = set()
            self.generation += 1
            self.epoch = epoch
            self.events.append(("shrink", dead, self.generation, epoch))
            gen = self.generation
        _obs_metrics.set_gauge("membership.generation", gen)
        _obs_metrics.set_gauge("membership.world_size", self.num_shards)
        _obs_event("membership.shrink", shard=dead, epoch=epoch,
                   generation=gen)
        return gen

    def check_generation(self, have: int, *, epoch: int = -1,
                         it: int = -1) -> None:
        """Refuse a world-stamped artifact from another generation.
        ``have < 0`` means unstamped (built before membership existed or
        outside a Trainer) and passes — only a *known-old* stamp is a
        defect worth replaying for."""
        if have < 0 or have == self.generation:
            return
        raise StaleGeneration(
            f"plan built under membership generation {have} dispatched "
            f"under generation {self.generation} (epoch {epoch}, it {it})",
            have=have, want=self.generation, epoch=epoch, it=it)
