"""Dispatch for the port's kernels.

A tensor on a CUDA device launches the hand-written kernel
(:mod:`repro_torch.kernels.gather_agg`, :mod:`repro_torch.kernels.linattn`),
which raises on anything it does not take; a tensor on the CPU takes the
plain version (:mod:`ref`). The one other branch is the reference's own:
``linattn`` with a given incoming state runs the chunked plain version on
either device, as the reference runs ``linattn_chunked_jnp`` there. There
is no fallback from a kernel to its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gather_agg as _ga
from repro_torch.kernels import linattn as _la
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


def linattn(q, k, v, w, u, state=None, chunk: int = 64):
    """RWKV6 gated linear attention over a sequence. Returns (o, S_out).
    From a zero state on CUDA this is the hand-written kernel; with an
    incoming state, or on the CPU, the chunked plain version."""
    if state is None and q.device.type == "cuda":
        return _la.linattn_chunked(q, k, v, w, u, chunk=chunk)
    return _ref.linattn_chunked_ref(q, k, v, w, u, state=state, chunk=chunk)


def linattn_step(q, k, v, w, u, state):
    """Single-token decode update (plain tensor code on every device).

    q, k, w: (BH, dk); v: (BH, dv); u: (dk,) or (BH, dk); state:
    (BH, dk, dv) float32. Returns (o (BH, dv) in q's dtype, new state)."""
    qf, kf, vf, wf = (x.float() for x in (q, k, v, w))
    uf = u.float().expand(q.shape)
    bonus = (qf * uf * kf).sum(-1, keepdim=True)
    o = torch.bmm(qf[:, None], state)[:, 0] + bonus * vf
    new_state = wf[..., None] * state + kf[..., None] * vf[:, None, :]
    return o.to(q.dtype), new_state
