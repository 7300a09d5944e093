"""Plain PyTorch versions of the port's kernels.

Each function defines the semantics of the matching CUDA kernel in
:mod:`repro_torch.kernels.gather_agg` or :mod:`repro_torch.kernels.linattn`,
in the kernel's own arithmetic order, so the two agree bit for bit where the
order is the same. The ops layer runs these for tensors on the CPU;
``chip_smoke.py`` holds the kernels against them on the card.
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


def linattn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 gated linear attention as a token-by-token scan.

    Per batch·head, with S (dk, dv), for t = 1..T:
        o_t = q_t · S + ((q_t ⊙ u) · k_t) v_t
        S   = diag(w_t) S + k_t ⊗ v_t
    q, k, w: (BH, T, dk); v: (BH, T, dv); u: (dk,) or (BH, dk); state:
    (BH, dk, dv) or None (zeros). Returns (o (BH, T, dv) in q's dtype,
    S_out float32)."""
    bh, T, dk = q.shape
    dv = v.shape[-1]
    S = (torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
         if state is None else state.float())
    qf, kf, vf, wf = (x.float() for x in (q, k, v, w))
    uf = u.float().expand(bh, dk)
    outs = []
    for t in range(T):
        qt, kt, vt = qf[:, t], kf[:, t], vf[:, t]
        bonus = ((qt * uf) * kt).sum(-1, keepdim=True)
        outs.append(torch.bmm(qt[:, None], S)[:, 0] + bonus * vt)
        S = wf[:, t, :, None] * S + kt[:, :, None] * vt[:, None, :]
    o = torch.stack(outs, 1) if outs else vf.new_zeros((bh, 0, dv))
    return o.to(q.dtype), S


def linattn_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        state: torch.Tensor | None = None, chunk: int = 64
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked formulation of :func:`linattn_ref`, in the CUDA kernel's
    arithmetic order (and the TPU kernel's, and the reference's
    ``linattn_chunked_jnp``): with e the inclusive cumprod of w inside a
    chunk, e_{t-1} = e_t / w_t,

        o     = (q ⊙ e_{t-1}) · S + causal((q ⊙ e_{t-1}) · (k / e)ᵀ) · v
                + ((q ⊙ u) · k) v
        S_out = diag(e_C) S + (k ⊙ e_C / e)ᵀ v

    all in float32. Shapes as :func:`linattn_ref`; ``T % chunk == 0``.
    ``state`` (BH, dk, dv) continues a sequence (the kernel starts from
    zeros only). Returns (o (BH, T, dv) in q's dtype, S_out float32)."""
    bh, T, dk = q.shape
    dv = v.shape[-1]
    if chunk < 1 or T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    S = (torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
         if state is None else state.float())
    qf, kf, vf, wf = (x.float() for x in (q, k, v, w))
    uf = u.float().expand(bh, dk)[:, None, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril(-1)
    outs = []
    for c0 in range(0, T, chunk):
        qb, kb, vb, wb = (x[:, c0:c0 + chunk] for x in (qf, kf, vf, wf))
        e = torch.cumprod(wb, dim=1)
        q_dec = qb * (e / wb)
        att = torch.bmm(q_dec, (kb / e).transpose(1, 2))
        att = torch.where(causal, att, torch.zeros((), device=q.device))
        bonus = ((qb * uf) * kb).sum(-1, keepdim=True)
        outs.append(torch.bmm(q_dec, S) + torch.bmm(att, vb) + bonus * vb)
        e_last = e[:, -1:]
        S = e_last.transpose(1, 2) * S \
            + torch.bmm((kb * (e_last / e)).transpose(1, 2), vb)
    o = torch.cat(outs, 1) if outs else vf.new_zeros((bh, 0, dv))
    return o.to(q.dtype), S
