"""Deterministic world rebuild after a confirmed peer death.

The port of ``repro.membership.recovery``.

Every survivor computes the new world locally from the same inputs —
``(part, dead, mode)`` — so the "recovery barrier" needs no coordination
service: :func:`rebuild_world` is a pure function, and equal inputs give
every survivor byte-identical ``part``/``owner``/``local_idx`` maps. The
Trainer then rebuilds the stateful side (FeatureStore tiers, ShapeBudget
buckets, cache, prefetcher) against the returned maps and reloads
params/opt from the shared crash-atomic checkpoint.

Recovery modes (``ResiliencePolicy.membership_mode``):

* ``"rejoin"`` — a replacement worker takes the dead rank: the partition
  is unchanged, features are restored from the authoritative source, and
  the resumed run is **bit-identical** to the fault-free one (the
  partition maps, seeds, and checkpointed params are all exactly what
  they were).
* ``"redistribute"`` / ``"adopt"`` — elastic shrink: survivors re-own the
  lost vertices (``graph.partition.reassign_partition``) and continue at
  world size P-1. Numerics legitimately change (different shard batches,
  different gradient reduction groups), so correctness is gated on
  loss-curve tolerance vs a fresh same-world-size baseline, not parity.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.partition import (local_index_map,
                                         reassign_partition)


@dataclasses.dataclass
class WorldRebuild:
    """The new world's partition maps (pure data, no device state)."""

    part: np.ndarray          # (n,) new shard assignment, compacted ids
    owner: np.ndarray         # (n,) = part (int32)
    local_idx: np.ndarray     # (n,) row within the owning shard
    max_part_size: int        # rectangular shard height
    num_shards: int           # P - 1 for elastic modes
    dead: int                 # the shard that died (old id space)
    mode: str
    moved_rows: int           # vertices whose owner changed


def rebuild_world(part: np.ndarray, dead: int, num_shards: int, *,
                  mode: str = "redistribute",
                  adopter: int | None = None) -> WorldRebuild:
    """Compute the post-death world for an elastic mode.

    Deterministic in its arguments (no RNG, no wall clock): survivors
    agree on the result without exchanging it. ``mode="rejoin"`` is not a
    rebuild — the partition is unchanged by construction — and is
    rejected here to keep the call sites honest."""
    if mode not in ("redistribute", "adopt"):
        raise ValueError(
            f"rebuild_world handles elastic modes only, got {mode!r} "
            "(rejoin keeps the old world)")
    part = np.asarray(part)
    new_part = reassign_partition(part, dead, parts=num_shards, mode=mode,
                                  adopter=adopter)
    owner, local_idx, max_sz = local_index_map(new_part, num_shards - 1)
    # a vertex moved if its new owner differs from its compacted old owner
    old_compact = part.astype(np.int32).copy()
    old_compact[old_compact > dead] -= 1
    moved = int(np.count_nonzero((new_part != old_compact)
                                 | (part == dead)))
    return WorldRebuild(part=new_part, owner=owner, local_idx=local_idx,
                        max_part_size=int(max_sz),
                        num_shards=num_shards - 1, dead=int(dead),
                        mode=mode, moved_rows=moved)
