"""Dispatch for the port's kernels.

A tensor on a CUDA device launches the hand-written kernel
(:mod:`repro_torch.kernels.gather_agg`, :mod:`repro_torch.kernels.linattn`),
which raises on anything it does not take — a gather from a table that
requires grad included, since the gather kernels run forward only; a
tensor on the CPU takes the plain version (:mod:`ref`), which autograd
differentiates. The one other branch is the reference's own: ``linattn``
with a given incoming state runs the chunked plain version on either
device, as the reference runs ``linattn_chunked_jnp`` there. There is no
fallback from a kernel to its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gather_agg as _ga
from repro_torch.kernels import linattn as _la
from repro_torch.kernels import ref as _ref


def needs_backward(table: torch.Tensor) -> bool:
    """Whether autograd would want a gradient through a gather of
    ``table``. The gather kernels run forward only (the reference's Pallas
    kernels have no VJP and it never differentiates the workspace), so on
    CUDA this is refused rather than answered with a result cut off from
    the graph."""
    return table.requires_grad and torch.is_grad_enabled()


def _forward_only(table: torch.Tensor, name: str) -> None:
    if needs_backward(table):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and "
                           f"the table requires grad; gather under "
                           f"torch.no_grad() or from a table that does not "
                           f"require grad")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]."""
    if table.device.type == "cpu":
        return _ref.gather_rows_ref(table, idx)
    _forward_only(table, "gather_rows")
    return _ga.gather_rows(table, idx)


def gather_agg(table: torch.Tensor, idx: torch.Tensor,
               reduce: str = "sum") -> torch.Tensor:
    """out[i] = reduce_j table[idx[i, j]] (fused gather + segment reduce)."""
    if table.device.type == "cpu":
        return _ref.gather_agg_ref(table, idx, reduce=reduce)
    _forward_only(table, "gather_agg")
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
