"""Deterministic epoch-level cache prefetch.

The repo's sampler is stateless (``_splitmix64`` over (vertex, slot, hop,
seed) — repro_torch.graph.sampler): the tree below a root is a pure function of
(root, seed), and the Trainer derives both its roots and its sample seeds
from (epoch, iteration). So *next* epoch's remote-feature requests are
computable **now**, before the epoch runs — RapidGNN's central observation.
:class:`EpochPrefetcher` replays the sampling pipeline for a future epoch on
the host (no device work, runs on the Trainer's cache thread while the
current epoch executes) and returns per-shard request-frequency tables the
admission policy turns into the next cached set.

Prediction fidelity: a §5.3 merge moves some merged roots to the hosting
server of their target step, so replaying the *unmerged* rotation would
mispredict the requesting shard for those roots — the cache then simply
misses them (misses are fetched through the ordinary exchange; correctness
is never at stake). The ``fold_steps`` hook closes that gap: the Trainer
wires it to fold each predicted assignment to the merging controller's
current pattern exactly like build_plan does, so the forecast is exact
with merging off *and* under a frozen merge with the paper's deterministic
"min" selector (the RD baseline's random folds consume controller RNG
state and cannot be replayed ahead of time — those predictions stay
unfolded). With an exact forecast a covering budget yields a 100% hit
rate.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.micrograph import (hopgnn_assignment, lo_assignment,
                                   model_centric_assignment)
from repro_torch.graph.sampler import sample_tree_block


class EpochPrefetcher:
    """Replays sampling for a future epoch → per-shard hot-set frequencies.

    ``roots_for(epoch, it)`` must be the Trainer's own deterministic root
    draw; ``sample_seed_for(epoch, it)`` its seed schedule. Both are plain
    callables so the prefetcher stays decoupled from the Trainer object
    (benchmarks drive it standalone).
    """

    def __init__(self, *, graph, part: np.ndarray, owner: np.ndarray,
                 num_shards: int, num_layers: int, fanout: int,
                 roots_for: Callable[[int, int], Sequence[np.ndarray]],
                 sample_seed_for: Callable[[int, int], int],
                 strategy: str = "hopgnn",
                 fold_steps: Optional[Callable] = None):
        self.graph = graph
        self.part = np.asarray(part)
        self.owner = np.asarray(owner)
        self.num_shards = int(num_shards)
        self.num_layers = int(num_layers)
        self.fanout = int(fanout)
        self.roots_for = roots_for
        self.sample_seed_for = sample_seed_for
        self.strategy = strategy
        self.fold_steps = fold_steps   # optional merge-pattern application

    def _assignment(self, roots):
        roots = [np.asarray(r, np.int64) for r in roots]
        if self.strategy == "model_centric":
            amat = model_centric_assignment(roots)
        elif self.strategy == "lo":
            amat = lo_assignment(roots, self.part)
        else:
            amat = hopgnn_assignment(roots, self.part)
        if self.fold_steps is not None:
            amat = self.fold_steps(amat)
        return amat

    def iteration_sets(self, epoch: int, it: int) -> list[np.ndarray]:
        """Per-requesting-shard deduped ids (local AND remote) one future
        iteration touches. (The reference also forecasts per-owner reads
        from these for the tiered store's readahead, which arrives with
        streamed training.)"""
        roots = self.roots_for(epoch, it)
        amat = self._assignment(roots)
        seed = self.sample_seed_for(epoch, it)
        n = amat.num_shards
        per_shard: list[list[np.ndarray]] = [[] for _ in range(n)]
        for s in range(n):
            for t in range(amat.num_steps):
                r = amat.roots_at(s, t)
                if r.size == 0:
                    continue
                blk = sample_tree_block(self.graph, r, self.num_layers,
                                        self.fanout, seed=seed)
                per_shard[s].append(blk.all_ids())
        return [np.unique(np.concatenate(ps)) if ps
                else np.zeros(0, np.int64) for ps in per_shard]

    def iteration_requests(self, epoch: int, it: int
                           ) -> list[np.ndarray]:
        """Per-shard deduped remote ids one future iteration will request —
        exactly the sets ``build_gather_plan`` would dedup to (§5.2)."""
        sets = self.iteration_sets(epoch, it)
        return [ids[self.owner[ids] != s] for s, ids in enumerate(sets)]

    def epoch_requests(self, epoch: int, iters: int
                       ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per-shard (ids, request_counts) over a whole future epoch: the
        count of iterations in which each remote id will be requested — the
        exact frequency table an LFU ranks by. Per-iteration sets are
        already deduped, so one unique-with-counts over their concatenation
        at the end is the whole merge (no per-iteration re-sorting)."""
        n = self.num_shards
        per_shard: list[list[np.ndarray]] = [[] for _ in range(n)]
        for it in range(iters):
            reqs = self.iteration_requests(epoch, it)
            for s in range(min(n, len(reqs))):
                if reqs[s].size:
                    per_shard[s].append(reqs[s])
        out = []
        for s in range(n):
            if per_shard[s]:
                ids, cnt = np.unique(np.concatenate(per_shard[s]),
                                     return_counts=True)
                out.append((ids, cnt.astype(np.int64)))
            else:
                out.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
        return out

    def covering_rows(self, epoch: int, iters: int) -> int:
        """The per-shard row budget that covers *every* remote request of
        the epoch (the 100%-hit-rate point benchmarks sweep toward)."""
        hot = self.epoch_requests(epoch, iters)
        return max((ids.size for ids, _ in hot), default=0)
