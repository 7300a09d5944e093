"""Serving planner: a micro-batch of vertices -> a device-ready InferencePlan.

The inference half of the reference planner (``repro.core.strategies``):
stateless tree sampling, unique-row dedup against the hot-cache index, and
translation of every tree position into the ``[cached | fetched]``
workspace. ``plan_iteration`` (the training planner) arrives with the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.pregather import PlanOverflow
from repro_torch.graph.sampler import TreeBlock, sample_tree_block
from repro_torch.graph.structs import CSRGraph


def _pad_tree_block(blk: TreeBlock, batch_pad: int,
                    pad_vertex: int) -> TreeBlock:
    """Pad a sampled block to ``batch_pad`` roots with a constant vertex at
    every position of every padded subtree (rows computed and discarded).
    True-root hops are shared, not copied."""
    k = blk.batch_size
    if k == batch_pad:
        return blk
    f = blk.fanout
    hops = [np.concatenate(
        [ids, np.full((batch_pad - k) * f ** h, pad_vertex, ids.dtype
                      if ids.size else np.int64)])
        for h, ids in enumerate(blk.hops)]
    return TreeBlock(hops=hops, fanout=f)


@dataclasses.dataclass
class InferencePlan:
    """One serving micro-batch, planned host-side for the compiled forward.

    The workspace layout is ``[cached | fetched]``: the server's hot
    feature rows (a repro_torch.cache CacheStore, height ``c_max``) followed by
    the batch's remaining unique rows, host-gathered through the feature
    store's tier chain. ``hop_idx[h]`` indexes that workspace for every
    tree position of hop h. The fetched-region *height* is not fixed here —
    positions only ever point below ``c_max + fetch_ids.size``, so the
    server pads the gather buffer to its ShapeBudget rung (``u_max``)
    without re-planning (unlike training, there is no exchange array whose
    shape the planner must commit to).
    """

    nodes: np.ndarray            # (k,) true requested vertices, caller order
    batch_pad: int               # padded root count (pow2 serve rung)
    fanout: int
    c_max: int                   # cached-region height the plan indexes into
    cache_version: int           # CacheIndex.version guarded at dispatch
    hop_idx: list                # [h]: (batch_pad * fanout**h,) int32
    fetch_ids: np.ndarray        # sorted unique global ids to host-gather
    cache_hit_rows: int          # unique rows served from the cached region
    touched: np.ndarray          # sorted unique ids of the TRUE trees
    touched_counts: np.ndarray   # aligned multiplicities (admission signal)

    @property
    def num_layers(self) -> int:
        return len(self.hop_idx) - 1


def plan_inference(graph: CSRGraph, nodes: np.ndarray, num_layers: int,
                   fanout: int, *, sample_seed: int,
                   batch_pad: Optional[int] = None,
                   cache_index=None,
                   pad_vertex: int = 0) -> InferencePlan:
    """Plan one serving micro-batch: sample, dedup, translate.

    The stateless sampler makes each root's tree a pure function of
    ``(root, sample_seed)`` — independent of batch composition — and the
    forward is row-wise per root, so a served vertex's logits do not depend
    on how the micro-batcher packed it (up to the matmul library's choice
    of algorithm per shape; see PERF.md). The plan itself is bit-identical
    to the reference planner's. Padding roots (``pad_vertex`` trees filling
    the rung) are computed and discarded.

    ``cache_index`` splits unique ids into hot rows (already device-resident
    in the serve cache, slot < c_max) and ``fetch_ids`` misses; indices are
    translated against the ``[cached | fetched]`` layout in one searchsorted
    pass — the same SlotMap idiom as the training GatherPlan.
    """
    nodes = np.asarray(nodes, np.int64).ravel()
    k = int(nodes.size)
    if batch_pad is None:
        batch_pad = max(k, 1)
    if k > batch_pad:
        raise PlanOverflow("batch_pad", k, int(batch_pad))
    blk = sample_tree_block(graph, nodes, num_layers, fanout,
                            seed=sample_seed)
    touched, touched_counts = np.unique(blk.all_ids(), return_counts=True)
    blk = _pad_tree_block(blk, int(batch_pad), int(pad_vertex))
    uniq = blk.unique_ids()

    if cache_index is not None:
        hit, slots = cache_index.hit_split(0, uniq)
        c_max = int(cache_index.c_max)
        version = int(cache_index.version)
    else:
        hit = np.zeros(uniq.size, bool)
        slots = np.zeros(uniq.size, np.int64)
        c_max, version = 0, 0
    miss = ~hit
    fetch_ids = uniq[miss]
    # workspace position of uniq[i]: its cache slot on a hit, else c_max +
    # rank among the misses (fetched rows are uploaded in sorted-id order)
    wspos = np.where(hit, slots, c_max + np.cumsum(miss) - 1)
    hop_idx = [wspos[np.searchsorted(uniq, ids)].astype(np.int32)
               for ids in blk.hops]
    return InferencePlan(nodes=nodes, batch_pad=int(batch_pad),
                         fanout=int(fanout), c_max=c_max,
                         cache_version=version, hop_idx=hop_idx,
                         fetch_ids=fetch_ids,
                         cache_hit_rows=int(hit.sum()),
                         touched=touched, touched_counts=touched_counts)
