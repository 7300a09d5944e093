"""Synthetic graph datasets with community structure + power-law degrees.

The paper evaluates on Arxiv/Products (OGB) and UK/IN/IT (WebGraph). Those
are not redistributable inside this container, so we generate *structurally
analogous* graphs: power-law degree distribution, strong community locality
(which is what METIS exploits, and what micrograph locality relies on), and
the paper's feature dimensions. The UK/IN/IT datasets had random features in
the paper too (§7.1), so synthetic features are faithful there by
construction.

Scales are reduced (``scale`` multiplier) to fit a 1-core CPU container; the
*ratios* the paper measures (locality percentages, bytes per strategy,
α ratios) are scale-stable, which is what our benchmarks report.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch.graph.structs import CSRGraph, GraphDataset

# name -> (n_vertices, avg_degree, feat_dim, n_classes) at scale=1.0,
# mirroring Table 2's relative shapes.
DATASETS = {
    # paper:       #V      #E       dim
    "arxiv":    (169_000, 7.0, 128, 40),
    "products": (245_000, 25.0, 100, 47),   # products scaled 1/10
    "uk":       (100_000, 41.0, 600, 10),   # uk-2005 scaled 1/10
    "in":       (138_000, 12.0, 600, 10),   # in-2004 scaled 1/10
    "it":       (413_000, 28.0, 600, 10),   # it-2004 scaled 1/100
}


def _powerlaw_degrees(n: int, avg_deg: float, rng: np.random.Generator,
                      alpha: float = 2.1, d_min: int = 1) -> np.ndarray:
    """Draw a power-law degree sequence with the requested mean."""
    u = rng.random(n)
    # Pareto with exponent alpha, then rescale to hit the target mean.
    raw = d_min * (1.0 - u) ** (-1.0 / (alpha - 1.0))
    raw = np.minimum(raw, n / 4)  # clip hubs
    deg = np.maximum(1, np.round(raw * (avg_deg / raw.mean()))).astype(np.int64)
    return deg


def community_graph(n: int, avg_deg: float, n_communities: int,
                    p_intra: float, seed: int) -> tuple[CSRGraph, np.ndarray]:
    """Power-law graph with contiguous communities.

    Each vertex draws its degree from a power law; each edge endpoint is
    chosen within the community with probability ``p_intra`` (uniformly),
    otherwise globally. This yields the locality structure that METIS-like
    partitioners recover and that Table 1 measures.
    """
    rng = np.random.default_rng(seed)
    comm = (np.arange(n) * n_communities) // n  # contiguous blocks
    comm_start = np.searchsorted(comm, np.arange(n_communities))
    comm_size = np.bincount(comm, minlength=n_communities)

    deg = _powerlaw_degrees(n, avg_deg / 2.0, rng)  # half: symmetrization doubles
    m = int(deg.sum())
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    intra = rng.random(m) < p_intra
    # Intra-community endpoint: uniform within the source's community.
    c = comm[src]
    dst_intra = comm_start[c] + (rng.random(m) * comm_size[c]).astype(np.int64)
    # Inter-community endpoint: global, degree-biased via repeated src pool.
    dst_inter = src[rng.integers(0, m, size=m)]
    dst = np.where(intra, dst_intra, dst_inter)
    g = CSRGraph.from_edges(n, src, dst, symmetrize=True)
    return g, comm


def make_dataset(name: str, scale: float = 1.0, seed: int = 0,
                 feat_dim: int | None = None,
                 train_frac: float = 0.1,
                 spill_dir: str | None = None,
                 feature_budget_bytes: int = 0,
                 spill_chunk_rows: int = 1 << 16) -> GraphDataset:
    """Build a named synthetic dataset (see ``DATASETS``).

    Spill-to-disk (repro_torch.features): with ``spill_dir`` set, features whose
    total bytes exceed ``feature_budget_bytes`` (0 = always spill when a
    dir is given) are *generated chunked* straight into an on-disk ``.npy``
    memmap instead of host RAM — peak host memory is one
    ``spill_chunk_rows`` chunk, so graphs larger than the host budget
    generate fine. The Generator draws values sequentially from its
    bit-stream, so chunked draws are bitwise identical to the one-shot
    in-RAM array (asserted in tests) — spilling never changes the dataset.
    """
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    n0, avg_deg, dim0, n_classes = DATASETS[name]
    n = max(1024, int(n0 * scale))
    dim = feat_dim if feat_dim is not None else dim0
    n_comm = max(8, n // 2048)
    g, comm = community_graph(n, avg_deg, n_comm, p_intra=0.85, seed=seed)

    rng = np.random.default_rng(seed + 1)
    labels = (comm % n_classes).astype(np.int32)
    spill = (spill_dir is not None
             and (feature_budget_bytes <= 0
                  or n * dim * 4 > feature_budget_bytes))
    if spill:
        from numpy.lib.format import open_memmap
        path = Path(spill_dir)
        path.mkdir(parents=True, exist_ok=True)
        fpath = path / f"{name}_features.npy"
        mm = open_memmap(fpath, mode="w+", dtype=np.float32, shape=(n, dim))
        for a in range(0, n, spill_chunk_rows):
            b = min(a + spill_chunk_rows, n)
            mm[a:b] = rng.standard_normal((b - a, dim), dtype=np.float32)
        centers = rng.standard_normal((n_classes, dim), dtype=np.float32)
        # Make labels weakly predictable from community + neighborhood so
        # that accuracy-parity experiments (Table 3) have signal to learn.
        for a in range(0, n, spill_chunk_rows):
            b = min(a + spill_chunk_rows, n)
            mm[a:b] += 0.5 * centers[labels[a:b]]
        mm.flush()
        del mm
        feats = np.load(fpath, mmap_mode="r")
    else:
        feats = rng.standard_normal((n, dim), dtype=np.float32)
        centers = rng.standard_normal((n_classes, dim), dtype=np.float32)
        feats += 0.5 * centers[labels]
    train_mask = rng.random(n) < train_frac
    return GraphDataset(name=name, graph=g, features=feats, labels=labels,
                        train_mask=train_mask, num_classes=n_classes,
                        communities=comm)
