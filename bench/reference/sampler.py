"""Fixed-fanout neighbour sampling, stateless per root (a frozen copy of
the repository's SplitMix64 sampler).

The tree below a root is a pure function of (root, seed): slot ``j`` of
vertex ``v`` at hop ``h`` takes neighbour ``hash(v, j, h, seed) mod
deg(v)``, with replacement; a vertex of degree 0 loops to itself. So the
trees of an iteration do not depend on how a strategy groups the roots,
and a model-centric reference samples exactly the trees LeapGNN trains on.
"""
from __future__ import annotations

import numpy as np


def splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def sample_hop(indptr: np.ndarray, indices: np.ndarray, frontier: np.ndarray,
               fanout: int, seed: int, hop: int) -> np.ndarray:
    """(m,) frontier -> (m * fanout,) sampled neighbours."""
    deg = indptr[frontier + 1] - indptr[frontier]
    with np.errstate(over="ignore"):
        key = (frontier.astype(np.uint64)[:, None]
               * np.uint64(0x100000001B3)
               + np.arange(fanout, dtype=np.uint64)[None, :]
               + np.uint64(hop) * np.uint64(0x9E3779B9)
               + np.uint64(seed) * np.uint64(0xDEADBEEF63))
    offs = (splitmix64(key)
            % np.maximum(deg, 1).astype(np.uint64)[:, None]).astype(np.int64)
    flat = (indptr[frontier][:, None] + offs).reshape(-1)
    nbrs = np.asarray(indices)[np.minimum(flat, indices.shape[0] - 1)
                               ].astype(np.int64)
    return np.where(np.repeat(deg == 0, fanout), np.repeat(frontier, fanout),
                    nbrs)


def sample_tree(indptr: np.ndarray, indices: np.ndarray, roots: np.ndarray,
                num_layers: int, fanout: int, seed: int) -> list:
    """Hops 0..num_layers of the roots' trees: hop h holds
    ``len(roots) * fanout**h`` vertex ids, the children of entry i of hop
    h at ``[i * fanout, (i + 1) * fanout)`` of hop h + 1."""
    hops = [np.asarray(roots, np.int64)]
    for h in range(num_layers):
        hops.append(sample_hop(indptr, indices, hops[-1], fanout, seed, h))
    return hops
