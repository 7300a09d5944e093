"""Shared transformer building blocks: inits, linear layers, RMSNorm,
LayerNorm, RoPE, the cross-entropy and the sharding hints.

Parameters are plain dicts of tensors, as the reference's are plain dict
pytrees, so a reference tree converts leaf by leaf
(:func:`repro_torch.models.transformer.model.params_from_jax`). A linear
layer keeps the reference's layout ``y = x @ w`` with ``w`` of shape
``(d_in, d_out)``, so weights carry across with no transpose. Random draws
take an explicit ``torch.Generator`` on the device they are drawn on.

The sharding hints (``set_mesh_axes``, ``resolve_axes``, ``shard``) are the
reference's GSPMD annotations as DTensor redistributions: on a plain tensor
``shard`` returns its argument itself, so one card computes what it did
without them; on a DTensor it moves the tensor to the placements its
logical spec names (``"dp"``, ``"tp"``, mesh axis names or None per dim).
:func:`gather_fsdp` is ZeRO-3's gather at use, which the reference's FSDP
recipe states (``launch/sharding.py``) and GSPMD inserts by itself: a
weight sharded over the dp axes is all-gathered over them before it is
used, keeping its ``model`` shard, and its gradient is reduce-scattered
back by DTensor's backward of that redistribution. :func:`split_heads`
gathers a projection over the TP axis before it is split into heads that
do not divide the TP shards (GSPMD pads them instead), and
:func:`gather_sequence` gathers the sequence-parallel carry before a
product. What is independent per batch row and head or channel —
attention's core, the linear attention, the RG-LRU conv and scan, RWKV6's
token shift, MoE's dispatch and combine, the embedding lookup under
autograd — runs on each rank's shards as plain tensors
(:func:`to_local_shards`, :func:`from_local_shards`): DTensor would merge
the sharded batch and head dims into a strided shard (torch 2.13, whose
every redistribution it plans by a graph search) or refuse to (2.11). A
sharded step
runs under ``torch.distributed.tensor.experimental.implicit_replication``
(``launch/dryrun.py`` and the host-mesh tests enter it): the tensors the
model makes itself — RoPE angles, masks, positions, zeros — are plain and
count as replicated on the mesh of the DTensors they meet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def he_normal(generator: torch.Generator, shape, dtype, fan_in=None,
              device=None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    x = torch.randn(shape, generator=generator, device=device)
    return (x * (2.0 / fan) ** 0.5).to(dtype)


def init_linear(generator: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False, device=None) -> dict:
    p = {"w": he_normal(generator, (d_in, d_out), dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b). On DTensors: ZeRO-3's gather of w at use
    (:func:`gather_fsdp`), the sequence-parallel gather of x
    (:func:`gather_sequence`), and the product's gradient brought back
    to the product's own placements before its backward, which flattens
    the leading dims (a gradient that arrives sharded on the sequence,
    from a sequence-parallel sum downstream, could not be)."""
    y = gather_sequence(x) @ gather_fsdp(p["w"])
    if _dtensor(y) and torch.is_grad_enabled():
        y = _GradLikeInput.apply(y)
    if "b" in p:
        y = y + p["b"]
    return y


def init_rmsnorm(d: int, dtype, device=None) -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32, cast back to x's dtype, then scaled."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p["g"]


def init_layernorm(d: int, dtype, device=None) -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean and population variance (``jnp.var``'s, not the unbiased one)
    in float32, cast back to x's dtype, then scaled and shifted."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["g"] + p["b"]


# ---------------------------------------------------------------------------
# Sharding hints
# ---------------------------------------------------------------------------

# Logical→mesh axis mapping. The launcher rebinds "dp" to ("pod", "data")
# for the multi-pod mesh; models only ever name logical axes.
_MESH_AXES = {"dp": ("data",), "tp": ("model",)}


def set_mesh_axes(dp, tp) -> None:
    _MESH_AXES["dp"] = tuple(dp) if isinstance(dp, (tuple, list)) else (dp,)
    _MESH_AXES["tp"] = tuple(tp) if isinstance(tp, (tuple, list)) else (tp,)


def resolve_axes(name):
    if name == "dp":
        return _MESH_AXES["dp"]
    if name == "tp":
        ax = _MESH_AXES["tp"]
        return ax[0] if len(ax) == 1 else ax
    return name


def _dtensor(x) -> bool:
    """Whether x is a DTensor (a plain tensor answers at once, without
    importing ``torch.distributed.tensor``)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements_for(mesh, spec) -> list:
    """One ``Shard(d)`` or ``Replicate()`` per dim of ``mesh``: the mesh
    axes a spec entry names (an axis name or a tuple of them, in mesh
    order, the first outermost) shard tensor dim d; every other mesh axis
    replicates. ``None`` replicates everything."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec or ()):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {names[i]} "
                                 f"twice")
            out[i] = Shard(d)
    return out


def _fitted(mesh, shape, spec) -> tuple:
    """A logical spec resolved to mesh axes for a tensor of ``shape``: each
    dim sharded over as many of its axes as its size divides into, the
    outermost dropped first, as the reference's ``dp_for_batch`` degrades
    a batch (a 16-row microbatch over ("pod", "data") shards over "data";
    one row replicates). GSPMD pads an uneven dim instead; DTensor's
    views of one miscount its local rows."""
    out = []
    for size, s in zip(shape, spec):
        if s is None:
            out.append(None)
            continue
        axes = []
        for a in ((s,) if isinstance(s, str) else s):
            r = resolve_axes(a)
            axes += [r] if isinstance(r, str) else list(r)
        while axes and size % math.prod(
                mesh.size(mesh.mesh_dim_names.index(a)) for a in axes):
            axes.pop(0)
        out.append(None if not axes else
                   axes[0] if len(axes) == 1 else tuple(axes))
    return tuple(out)


def shard(x, *spec):
    """The reference's ``with_sharding_constraint`` with logical axis
    names ("dp"/"tp"): x itself when it is a plain tensor (one card, or
    no mesh); a DTensor redistributed to the spec's placements on its
    mesh (a pending partial sum is reduced), each dim sharded only over
    the axes its size divides into (:func:`_fitted`)."""
    if not _dtensor(x):
        return x
    want = placements_for(x.device_mesh,
                          _fitted(x.device_mesh, x.shape, spec))
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def gather_fsdp(w):
    """A weight with its shards over the dp axes gathered (ZeRO-3 at
    use), keeping its ``model`` placement; w itself when it is a plain
    tensor or has no dp shard (``fsdp=False``)."""
    if not _dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    dp = set(_MESH_AXES["dp"])
    want = [Replicate() if names[i] in dp and pl.is_shard() else pl
            for i, pl in enumerate(w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def gather_sequence(x):
    """x with its inner dims (all but the first and the last) gathered:
    the sequence-parallel all-gather before a projection, which GSPMD
    inserts by itself. A product flattens the leading dims, and DTensor
    cannot flatten a dim sharded after the first. x itself when it is a
    plain tensor or has no such shard."""
    if not _dtensor(x) or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate
    last = x.dim() - 1
    want = [Replicate() if pl.is_shard() and 0 < pl.dim % x.dim() < last
            else pl for pl in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def split_heads(y: torch.Tensor, heads: int, head_dim: int
                ) -> torch.Tensor:
    """(..., heads·head_dim) → (..., heads, head_dim). A DTensor whose
    last dim is sharded over mesh axes whose shard count does not divide
    ``heads`` is first gathered over them (an all-gather the census
    counts): DTensor cannot split a sharded dim into a head dim it would
    shard unevenly, where GSPMD pads the heads."""
    if _dtensor(y):
        from torch.distributed.tensor import Replicate
        d = y.dim() - 1
        mesh = y.device_mesh
        n = 1
        for i, pl in enumerate(y.placements):
            if pl.is_shard() and pl.dim % y.dim() == d:
                n *= mesh.size(i)
        if heads % n:
            want = [Replicate() if pl.is_shard() and pl.dim % y.dim() == d
                    else pl for pl in y.placements]
            y = y.redistribute(mesh, want)
    return y.reshape(*y.shape[:-1], heads, head_dim)


def tp_size(mesh) -> int:
    """The number of shards of the TP axes on ``mesh``."""
    n = 1
    for a in _MESH_AXES["tp"]:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def to_local_shards(x, *spec, shared: bool = False) -> torch.Tensor:
    """This rank's shard of DTensor x placed by the logical spec (a
    redistribution first where x is placed otherwise); differentiable.
    ``shared``: x is replicated over the dp axes and read by every batch
    shard, so its gradient is a partial sum over them."""
    x = shard(x, *spec)
    if not shared:
        return x.to_local()
    from torch.distributed.tensor import Partial
    names = x.device_mesh.mesh_dim_names
    dp = set(_MESH_AXES["dp"])
    return x.to_local(grad_placements=[
        Partial() if names[i] in dp and pl.is_replicate() else pl
        for i, pl in enumerate(x.placements)])


def from_local_shards(local: torch.Tensor, mesh, shape, *spec):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local``, placed by the logical spec; differentiable."""
    from torch.distributed.tensor import DTensor
    flat = _fitted(mesh, shape, spec)
    stride, n = [], 1
    for d in reversed(shape):
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(local.contiguous(), mesh,
                              placements_for(mesh, flat),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


class _GradLikeInput(torch.autograd.Function):
    """Identity whose backward hands the gradient on in the placements
    its input had (a pending partial sum's gradient replicated)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.placements = tuple(Replicate() if pl.is_partial() else pl
                               for pl in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(..., heads, head_dim) → (..., heads·head_dim). A DTensor whose
    heads are not sharded (:func:`split_heads` gathered them) gets its
    gradient back unsharded too, where the next product would hand it on
    sharded over TP and DTensor could not split it into the heads."""
    y = o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1])
    if _dtensor(o) and not any(pl.is_shard() and pl.dim % o.dim() == o.dim() - 2
                               for pl in o.placements) \
            and torch.is_grad_enabled():
        y = _GradLikeInput.apply(y)
    return y


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    """(head_dim / 2,) float32 inverse frequencies, computed on the CPU so
    every device rotates by the same angles."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). The halves
    rotate in float32 and the result is cast back to x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta).to(x.device)                 # (Dh/2,)
    ang = positions[..., None].to(x.device, torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     -1).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL; logits (B, S, V) upcast to float32, labels
    (B, S) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
