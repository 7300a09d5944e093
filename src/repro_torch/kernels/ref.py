"""Plain PyTorch versions of the port's kernels.

Each function defines the semantics of the matching CUDA kernel in
:mod:`repro_torch.kernels.gather_agg`, in the kernel's own arithmetic
order, so the two agree bit for bit where the order is the same. The ops
layer runs these for tensors on the CPU; ``chip_smoke.py`` holds the
kernels against them on the card. ``linattn_ref`` arrives with the RWKV6
slice.
"""
from __future__ import annotations

import torch

REDUCES = ("sum", "mean", "max")


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]].  table: (R, d), idx: (n,) int32 -> (n, d)."""
    return table[idx.long()]


def gather_agg_ref(table: torch.Tensor, idx: torch.Tensor,
                   reduce: str = "sum") -> torch.Tensor:
    """Fused neighbour gather + aggregate over the fixed-fanout tree layout.
    table: (R, d), idx: (n, f) -> (n, d) in the table's dtype.

    The reduction runs in float32 in neighbour order 0..f-1, ``mean``
    divides once after the sum, and ``max`` starts from the first row —
    the order of the TPU kernel and of the CUDA kernel."""
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}; have {REDUCES}")
    n, f = idx.shape
    rows = table[idx.reshape(-1).long()].reshape(n, f, table.shape[1])
    acc = rows[:, 0].float()
    for j in range(1, f):
        v = rows[:, j].float()
        acc = torch.maximum(acc, v) if reduce == "max" else acc + v
    if reduce == "mean":
        acc = acc / f
    return acc.to(table.dtype)
