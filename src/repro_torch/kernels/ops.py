"""Dispatch for the port's kernels.

A tensor on a CUDA device launches the hand-written kernel
(:mod:`repro_torch.kernels.gather_agg`, :mod:`repro_torch.kernels.linattn`),
which raises on anything it does not take — an input that autograd would
want a gradient through included, since the kernels run forward only; a
tensor on the CPU takes the plain version (:mod:`ref`), which autograd
differentiates. ``linattn`` has the reference's two other branches: with a
given incoming state, or when autograd needs a gradient through it, it runs
:func:`linattn_chunked_torch` on either device, as the reference runs
``linattn_chunked_jnp`` for both (its training path). There is no fallback
from a kernel to its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gather_agg as _ga
from repro_torch.kernels import linattn as _la
from repro_torch.kernels import ref as _ref


def needs_backward(*tensors: torch.Tensor) -> bool:
    """Whether autograd would want a gradient through a call on
    ``tensors``. The kernels run forward only (the reference's Pallas
    kernels have no VJP), so on CUDA such a call is refused rather than
    answered with a result cut off from the graph."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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


def linattn_chunked_torch(q, k, v, w, u, state=None, chunk: int = 64):
    """The differentiable chunked formulation in plain PyTorch, the port of
    the reference's ``linattn_chunked_jnp``: the kernel's arithmetic in its
    order, one chunk after another carrying the state, on any device.
    Training runs it (autograd differentiates it); it is also the path of a
    call with an incoming state. Shapes as :func:`ref.linattn_chunked_ref`,
    whose body it is."""
    return _ref.linattn_chunked_ref(q, k, v, w, u, state=state, chunk=chunk)


def linattn(q, k, v, w, u, state=None, chunk: int = 64):
    """RWKV6 gated linear attention over a sequence. Returns (o, S_out).

    One rule, in this order: when autograd needs a gradient through the
    call (grad mode on and any of q, k, v, w, u requires grad), or when an
    incoming ``state`` is given, :func:`linattn_chunked_torch`; otherwise,
    on CUDA the hand-written kernel (from a zero state), and on the CPU its
    plain version."""
    if state is not None or needs_backward(q, k, v, w, u):
        return linattn_chunked_torch(q, k, v, w, u, state=state, chunk=chunk)
    if q.device.type == "cuda":
        return _la.linattn_chunked(q, k, v, w, u, chunk=chunk)
    return _ref.linattn_chunked_ref(q, k, v, w, u, chunk=chunk)


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
