"""Optimizers with the reference's own arithmetic (``repro.optim``).

Functional style, as the reference: ``opt = adamw(lr); state =
opt.init(params); params, state = opt.update(grads, state, params)``.
``params`` is a module with a ``leaves()`` method giving its tensors in the
reference's ``jax.tree.leaves`` order (:class:`repro_torch.models.gnn.GNN`
has one), a list of tensors in that order, or a tree of dicts and lists of
tensors (a transformer's parameters), whose leaves are taken with dict keys
sorted, as ``jax.tree.leaves`` takes them. ``grads`` is a list aligned
with those leaves, and the state's moments are lists in the same order —
so the global norm sums the leaves in the reference's order.

The update runs in place under ``torch.no_grad()``: the parameters' and the
moments' tensors are overwritten and returned. This stands in for the
reference's buffer donation (its inputs are dead after the call, as these
are). It is not ``torch.optim.AdamW``, which applies the decay before the
Adam step; here ``delta = mhat / (sqrt(vhat) + eps) + wd · p`` and then
``p - lr_t · delta``, as in the reference.

The scalars stay on the host: the state carries its step as an int32 CPU
tensor, and the learning rate and bias corrections are computed from it in
float32 on the CPU, as the reference computes them from its int32 step.
They reach the device's elementwise ops as Python floats that float32
represents exactly, so a step costs no host-device sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state), in place
    # Stable value identity for the engine's fused-train-step cache
    # (repro_torch.core.distributed.get_compiled_train_step): two optimizers
    # with the same hyperparameters share one entry. None (e.g. a schedule
    # callable for lr) falls back to instance identity.
    key: Optional[tuple] = None


def leaves(params) -> list:
    """The tensors of ``params`` in the reference's leaf order."""
    if isinstance(params, dict):
        return tree_leaves(params)
    if isinstance(params, (list, tuple)):
        return list(params)
    return list(params.leaves())


def tree_leaves(node) -> list:
    """The tensors of a tree of dicts and lists: dict keys sorted, lists in
    order."""
    if isinstance(node, dict):
        return [t for k in sorted(node) for t in tree_leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [t for v in node for t in tree_leaves(v)]
    return [node]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warmup then cosine decay; ``lr(step)`` is a float32 scalar
    computed on the CPU with the reference's operations in its order."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / float(max(1.0, warmup))
        frac = torch.clamp((step - float(warmup))
                           / float(max(1.0, total - warmup)), 0.0, 1.0)
        cos = (0.5 * base_lr) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (|g| + 1e-9))`` where
    ``|g|`` sums the squares leaf by leaf in the given order. Returns
    (clipped list, global norm) — both on the gradients' device."""
    grads = list(grads)
    scale, gn = _clip_scale(grads, max_norm)
    return [(g * scale).to(g.dtype) for g in grads], gn


def _clip_scale(grads: list, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0), gn


# An update works through the leaves in groups of at most this many
# elements, so its float32 temporaries stay a bounded size above the
# parameters and moments (a multi-billion-parameter model would otherwise
# need several float32 copies of itself at once). The arithmetic is
# elementwise, so the grouping changes no value.
_GROUP_ELEMS = 1 << 27


def _groups(ps: list) -> list:
    out, lo, n = [], 0, 0
    for i, p in enumerate(ps):
        if n and n + p.numel() > _GROUP_ELEMS:
            out.append((lo, i))
            lo, n = i, 0
        n += p.numel()
    if lo < len(ps):
        out.append((lo, len(ps)))
    return out


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the CPU
    mu: list
    nu: list


def _lr_at(lr, step: torch.Tensor) -> float:
    """The learning rate at ``step`` as a float that float32 represents."""
    if callable(lr):
        return float(_f32(lr(step)))
    return lr


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip: Optional[float] = None,
          state_dtype=torch.float32,
          key: Optional[tuple] = None) -> Optimizer:
    """AdamW with optional global-norm clipping.

    ``state_dtype`` keeps the moments in another type (they are computed in
    float32 and cast on store, as in the reference). ``key`` declares a
    value identity for a *callable* lr, which cannot be compared by value:
    pass e.g. ``key=("cos", base_lr, warmup, total)`` so optimizers built
    from equal schedules share one compiled train step."""

    def init(params):
        ps = leaves(params)
        return AdamState(step=torch.zeros((), dtype=torch.int32),
                         mu=[torch.zeros_like(p, dtype=state_dtype)
                             for p in ps],
                         nu=[torch.zeros_like(p, dtype=state_dtype)
                             for p in ps])

    @torch.no_grad()
    def update(grads, state, params):
        ps = leaves(params)
        gs = list(grads)
        scale = None
        if grad_clip is not None:
            scale, _ = _clip_scale(gs, grad_clip)
        step = state.step + 1
        t = _f32(step)
        c1 = float(1.0 - torch.pow(_f32(b1), t))
        c2 = float(1.0 - torch.pow(_f32(b2), t))
        lr_t = _lr_at(lr, step)
        for lo, hi in _groups(ps):
            g32 = [(g if scale is None else (g * scale).to(g.dtype)).float()
                   for g in gs[lo:hi]]
            _adamw_group(ps[lo:hi], g32, state.mu[lo:hi], state.nu[lo:hi],
                         b1, b2, c1, c2, eps, weight_decay, lr_t)
        return params, AdamState(step=step, mu=state.mu, nu=state.nu)

    dtype_name = str(state_dtype).removeprefix("torch.")
    if key is None and not callable(lr):
        key = ("adamw", float(lr), b1, b2, eps, weight_decay, grad_clip,
               dtype_name)
    elif key is not None:
        key = ("adamw", *key, b1, b2, eps, weight_decay, grad_clip,
               dtype_name)
    return Optimizer(init=init, update=update, key=key)


def _adamw_group(ps, g32, mu, nu, b1, b2, c1, c2, eps, weight_decay,
                 lr_t) -> None:
    """One group's AdamW step, written into ``ps``, ``mu`` and ``nu``."""
    m32 = [m.float() for m in mu]   # the same tensors where they are float32
    v32 = [v.float() for v in nu]
    torch._foreach_mul_(m32, b1)
    torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - b1))
    torch._foreach_mul_(v32, b2)
    torch._foreach_add_(v32, torch._foreach_mul(
        torch._foreach_mul(g32, g32), 1 - b2))
    delta = torch._foreach_div(m32, c1)                 # mhat
    den = torch._foreach_div(v32, c2)                   # vhat
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(delta, den)
    p32 = [p.float() for p in ps]
    torch._foreach_add_(delta, torch._foreach_mul(p32, weight_decay))
    torch._foreach_mul_(delta, lr_t)
    torch._foreach_sub_(p32, delta)
    for dst, src in ((ps, p32), (mu, m32), (nu, v32)):
        for a, b in zip(dst, src):
            if a is not b:
                a.copy_(b)


def adam(lr=1e-3, **kw) -> Optimizer:
    return adamw(lr=lr, weight_decay=0.0, **kw)


class SGDState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the CPU
    momentum: Optional[list]


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return SGDState(step=torch.zeros((), dtype=torch.int32),
                        momentum=([torch.zeros_like(p) for p in leaves(params)]
                                  if momentum else None))

    @torch.no_grad()
    def update(grads, state, params):
        ps = leaves(params)
        gs = list(grads)
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            torch._foreach_mul_(state.momentum, momentum)
            torch._foreach_add_(state.momentum, gs)
            torch._foreach_sub_(ps, torch._foreach_mul(state.momentum, lr_t))
            return params, SGDState(step=step, momentum=state.momentum)
        torch._foreach_sub_(ps, torch._foreach_mul(gs, lr_t))
        return params, SGDState(step=step, momentum=None)

    key = (("sgd", float(lr), momentum) if not callable(lr) else None)
    return Optimizer(init=init, update=update, key=key)
