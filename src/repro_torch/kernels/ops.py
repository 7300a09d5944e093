"""Dispatch for the port's kernels.

A tensor on a CUDA device launches the hand-written kernel
(:mod:`repro_torch.kernels.gather_agg`), which raises on anything it does
not take; a tensor on the CPU takes the plain version (:mod:`ref`). There
is no other branch and no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gather_agg as _ga
from repro_torch.kernels import ref as _ref


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]."""
    if table.device.type == "cpu":
        return _ref.gather_rows_ref(table, idx)
    return _ga.gather_rows(table, idx)


def gather_agg(table: torch.Tensor, idx: torch.Tensor,
               reduce: str = "sum") -> torch.Tensor:
    """out[i] = reduce_j table[idx[i, j]] (fused gather + segment reduce)."""
    if table.device.type == "cpu":
        return _ref.gather_agg_ref(table, idx, reduce=reduce)
    return _ga.gather_agg(table, idx, reduce=reduce)
