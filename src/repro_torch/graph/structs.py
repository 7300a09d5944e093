"""Core graph containers (host-side, numpy).

A ``CSRGraph`` stores out-neighborhoods in compressed-sparse-row form. GNN
sampling treats the graph as undirected unless stated otherwise; generators
in :mod:`repro_torch.graph.synthetic` symmetrize before building CSR.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed sparse row adjacency.

    Attributes:
      indptr:  (n+1,) int64 — row pointer.
      indices: (nnz,) int32 — column (neighbor) ids.
    """

    indptr: np.ndarray
    indices: np.ndarray

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                   symmetrize: bool = True) -> "CSRGraph":
        """Build CSR from an edge list, deduplicating and (optionally)
        symmetrizing. Self loops are dropped."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        keep = src != dst
        src, dst = src[keep], dst[keep]
        # Dedup (src,dst) pairs.
        key = src * n + dst
        key = np.unique(key)
        src, dst = key // n, key % n
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRGraph(indptr=indptr, indices=dst.astype(np.int32))

    def topology_bytes(self) -> int:
        return self.indptr.nbytes + self.indices.nbytes


@dataclasses.dataclass
class GraphDataset:
    """A graph + vertex features + labels + train split.

    Mirrors the paper's Table 2 inputs: topology volume ``Vol_G`` vs feature
    volume ``Vol_F`` (features dominate, which is what makes feature-centric
    training pay off).
    """

    name: str
    graph: CSRGraph
    features: np.ndarray        # (n, dim) float32
    labels: np.ndarray          # (n,) int32
    train_mask: np.ndarray      # (n,) bool
    num_classes: int
    communities: Optional[np.ndarray] = None  # ground-truth blocks if synthetic

    @property
    def num_vertices(self) -> int:
        return self.graph.num_vertices

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])

    def vol_g_bytes(self) -> int:
        return self.graph.topology_bytes()

    def vol_f_bytes(self) -> int:
        return int(self.features.nbytes)

    def train_vertices(self) -> np.ndarray:
        return np.nonzero(self.train_mask)[0].astype(np.int64)
