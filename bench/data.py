"""The benchmark's own inputs: a graph, vertex features, labels and a
training split, made from a configuration's ``dataset`` block.

The generator follows the repository's synthetic community generator
(power-law degrees, contiguous communities, edges inside the source's
community with probability ``p_intra`` and otherwise to the source of a
random edge, symmetrised and deduplicated CSR), drawn with a
``torch.Generator`` on the device in a few large calls, so a run makes the
public-size graph in seconds and writes nothing to disk. The arrays depend
only on the configuration's fixed dataset seed and the device's kind,
never on ``--seed``; the same arrays go to the program and to the
reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    """CSR adjacency: the neighbours of ``v`` are
    ``indices[indptr[v]:indptr[v + 1]]``."""
    indptr: np.ndarray     # (n + 1,) int64
    indices: np.ndarray    # (nnz,) int32

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])


@dataclasses.dataclass
class Dataset:
    graph: Graph
    features: np.ndarray   # (n, d) float32
    labels: np.ndarray     # (n,) int32
    train_mask: np.ndarray  # (n,) bool
    communities: np.ndarray  # (n,) int64
    num_classes: int

    @property
    def num_vertices(self) -> int:
        return self.graph.num_vertices

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])

    def train_vertices(self) -> np.ndarray:
        return np.nonzero(self.train_mask)[0].astype(np.int64)


def _powerlaw_degrees(n: int, avg_deg: float, g: torch.Generator, device,
                      alpha: float = 2.1) -> torch.Tensor:
    u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
    raw = torch.clamp((1.0 - u) ** (-1.0 / (alpha - 1.0)), max=n / 4)
    return torch.clamp(torch.round(raw * (avg_deg / raw.mean())),
                       min=1).long()


def _csr(n: int, src: torch.Tensor, dst: torch.Tensor) -> Graph:
    """Symmetrise, drop self loops, deduplicate; sorted by source, then
    destination."""
    s, t = torch.cat([src, dst]), torch.cat([dst, src])
    keep = s != t
    key = torch.unique(s[keep] * n + t[keep])       # sorted
    del s, t, keep
    src = torch.div(key, n, rounding_mode="floor")
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    del src
    indices = (key % n).int()
    return Graph(indptr=indptr.cpu().numpy(), indices=indices.cpu().numpy())


def generate(spec: dict, device="cpu") -> Dataset:
    """Make the dataset that ``spec`` (a configuration's ``dataset``
    block) describes, drawing on ``device``; the arrays come back on the
    host and the device's memory is freed."""
    n = int(spec["num_vertices"])
    d = int(spec["feature_dim"])
    n_classes = int(spec["num_classes"])
    seed = int(spec["seed"])
    n_comm = max(8, n // int(spec.get("community_size", 2048)))
    g = torch.Generator(device=device).manual_seed(seed)
    comm = torch.arange(n, device=device) * n_comm // n
    comm_start = torch.searchsorted(comm, torch.arange(n_comm,
                                                       device=device))
    comm_size = torch.bincount(comm, minlength=n_comm)
    deg = _powerlaw_degrees(n, float(spec["avg_degree"]) / 2.0, g, device)
    m = int(deg.sum())
    src = torch.repeat_interleave(torch.arange(n, device=device), deg)
    del deg
    c = comm[src]
    dst = comm_start[c] + (torch.rand(m, generator=g, dtype=torch.float64,
                                      device=device)
                           * comm_size[c]).long()
    del c
    inter = torch.rand(m, generator=g, device=device) >= \
        float(spec["p_intra"])
    pick = torch.randint(0, m, (m,), generator=g, device=device)
    dst[inter] = src[pick[inter]]
    del inter, pick
    graph = _csr(n, src, dst)
    del src, dst
    g.manual_seed(seed + 1)
    labels = (comm % n_classes).int()
    feats = torch.randn((n, d), generator=g, device=device)
    centers = torch.randn((n_classes, d), generator=g, device=device)
    feats += 0.5 * centers[labels]
    train_mask = torch.rand(n, generator=g, device=device) < \
        float(spec["train_frac"])
    out = Dataset(graph=graph, features=feats.cpu().numpy(),
                  labels=labels.cpu().numpy(),
                  train_mask=train_mask.cpu().numpy(),
                  communities=comm.cpu().numpy(), num_classes=n_classes)
    del feats, centers, labels, train_mask, comm
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def upload_features(ds, device, chunk: int = 1 << 18) -> torch.Tensor:
    """The whole feature array on ``device``, copied in chunks."""
    n, d = ds.features.shape
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for a in range(0, n, chunk):
        out[a:a + chunk] = torch.from_numpy(ds.features[a:a + chunk]).to(
            device)
    return out
