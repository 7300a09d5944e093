"""K-hop neighbor sampling (host-side, numpy).

TPU adaptation (see DESIGN.md §2): sampled neighborhoods are *fixed-fanout
trees*, giving rectangular (B, f, f², …) frontier arrays. On GPUs, DGL
builds ragged message-flow graphs; ragged layouts are hostile to the TPU's
static-shape compiler, so we sample **with replacement** to a fixed fanout
(the standard TPU-native formulation; when deg(v) >= fanout this draws
`fanout` distinct-in-expectation neighbors, and when deg(v) < fanout the
duplicates implement mean-aggregation weighting). Vertices with degree 0
self-loop.

A ``TreeBlock`` is the fundamental sampled unit. A *subgraph* (paper §2) is
a TreeBlock with B = mini-batch-size roots; a *micrograph* (paper §4) is a
TreeBlock with roots drawn from a single (home-server, model) group.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.graph.structs import CSRGraph


@dataclasses.dataclass
class TreeBlock:
    """Fixed-fanout k-hop sample.

    hops[0] = roots (B,), hops[h] = (B * f^h,) global vertex ids; the
    children of ``hops[h][i]`` are ``hops[h+1][i*f:(i+1)*f]``.
    """

    hops: list[np.ndarray]
    fanout: int

    @property
    def batch_size(self) -> int:
        return int(self.hops[0].shape[0])

    @property
    def num_layers(self) -> int:
        return len(self.hops) - 1

    @property
    def roots(self) -> np.ndarray:
        return self.hops[0]

    def all_ids(self) -> np.ndarray:
        """Every sampled vertex id, with duplicates (tree multiset)."""
        return np.concatenate(self.hops)

    def unique_ids(self) -> np.ndarray:
        return np.unique(self.all_ids())

    def num_feature_rows(self) -> int:
        """Feature rows gathered for this block (tree layout, with dups)."""
        return int(sum(h.shape[0] for h in self.hops))

    def locality(self, part: np.ndarray) -> float:
        """R_micro / R_sub of Table 1: fraction of non-root sampled vertices
        co-located (same partition) with this block's (first) root."""
        home = part[self.hops[0][0]]
        non_root = np.concatenate(self.hops[1:]) if len(self.hops) > 1 else np.array([], np.int64)
        if non_root.size == 0:
            return 1.0
        return float((part[non_root] == home).mean())

    def select(self, idx: np.ndarray) -> "TreeBlock":
        """Sub-block for a subset of roots (used by micrograph grouping)."""
        f = self.fanout
        hops = []
        pos = np.asarray(idx, dtype=np.int64)  # positions within hop h
        for ids in self.hops:
            hops.append(ids[pos])
            pos = (pos[:, None] * f + np.arange(f)[None, :]).reshape(-1)
        return TreeBlock(hops=hops, fanout=f)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — a counter-based hash usable as a stateless RNG."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _sample_neighbors(g: CSRGraph, frontier: np.ndarray, fanout: int,
                      rng: np.random.Generator | None,
                      seed: int | None = None, hop: int = 0) -> np.ndarray:
    """(m,) frontier -> (m*fanout,) sampled neighbors, with replacement.

    Two modes:
      * ``rng`` — stateful draw (fresh neighborhoods every call).
      * ``seed`` — *stateless* hash of (vertex, slot, hop, seed): the sampled
        tree below a root is a pure function of (root, seed), independent of
        which strategy/step groups the root. This is what makes LeapGNN's
        accuracy-fidelity claim (§5.1, Table 3) a *bitwise-testable*
        gradient-parity property instead of a statistical one.
    """
    deg = g.indptr[frontier + 1] - g.indptr[frontier]
    start = g.indptr[frontier]
    if seed is not None:
        with np.errstate(over="ignore"):
            key = (frontier.astype(np.uint64)[:, None]
                   * np.uint64(0x100000001B3)
                   + np.arange(fanout, dtype=np.uint64)[None, :]
                   + np.uint64(hop) * np.uint64(0x9E3779B9)
                   + np.uint64(seed) * np.uint64(0xDEADBEEF63))
        h = _splitmix64(key)
        offs = (h % np.maximum(deg, 1).astype(np.uint64)[:, None]).astype(np.int64)
    else:
        offs = (rng.random((frontier.shape[0], fanout)) *
                np.maximum(deg, 1)[:, None]).astype(np.int64)
    flat = (start[:, None] + offs).reshape(-1)
    nbrs = g.indices[np.minimum(flat, g.num_edges - 1)].astype(np.int64)
    # degree-0 vertices self-loop
    self_loop = np.repeat(deg == 0, fanout)
    nbrs = np.where(self_loop, np.repeat(frontier, fanout), nbrs)
    return nbrs


def sample_tree_block(g: CSRGraph, roots: np.ndarray, num_layers: int,
                      fanout: int, rng: np.random.Generator | None = None,
                      seed: int | None = None) -> TreeBlock:
    """Node-wise k-hop sampling (GraphSAGE-style) into a TreeBlock.

    Pass ``seed`` for stateless per-root-deterministic sampling (gradient
    parity across strategies), or ``rng`` for stateful sampling."""
    if (rng is None) == (seed is None):
        raise ValueError("pass exactly one of rng / seed")
    hops = [np.asarray(roots, dtype=np.int64)]
    for h in range(num_layers):
        hops.append(_sample_neighbors(g, hops[-1], fanout, rng,
                                      seed=seed, hop=h))
    return TreeBlock(hops=hops, fanout=fanout)


def layerwise_sample(g: CSRGraph, roots: np.ndarray, num_layers: int,
                     layer_size: int, rng: np.random.Generator
                     ) -> list[np.ndarray]:
    """Layer-wise (FastGCN-style) sampling: each layer draws a fixed-size,
    degree-biased vertex set shared by the whole batch. Used by the Table-1
    locality benchmark (the paper evaluates both sampling families)."""
    layers = [np.asarray(roots, dtype=np.int64)]
    deg = g.degrees().astype(np.float64)
    for _ in range(num_layers):
        # candidates: union of neighbors of the previous layer
        prev = layers[-1]
        cand = np.concatenate([g.neighbors(int(v)) for v in prev]) if prev.size else prev
        if cand.size == 0:
            layers.append(prev.copy())
            continue
        cand = np.unique(cand)
        p = deg[cand] + 1.0
        p /= p.sum()
        take = min(layer_size, cand.size)
        layers.append(rng.choice(cand, size=take, replace=False, p=p).astype(np.int64))
    return layers


def micrograph_split(block: TreeBlock) -> list[TreeBlock]:
    """Split a subgraph TreeBlock into per-root micrographs (paper §4)."""
    return [block.select(np.array([i])) for i in range(block.batch_size)]


def group_roots_by_home(roots: np.ndarray, part: np.ndarray, parts: int
                        ) -> list[np.ndarray]:
    """Step 1 of §5.1: group mini-batch roots by home server."""
    home = part[roots]
    return [roots[home == s] for s in range(parts)]
