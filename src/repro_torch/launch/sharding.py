"""FSDP × TP sharding policy of the transformer stack, as DTensor
placements.

The port of the reference's ``launch/sharding.py``, whose recipe it keeps:

* weight matrices shard their *input-feature* dim over ``data`` (ZeRO-3:
  gathered at use, :func:`repro_torch.models.transformer.common.gather_fsdp`,
  which bounds per-device parameter memory — a hard requirement for
  nemotron-4-340b) and their *output-feature* / head / ffn dim over
  ``model`` (Megatron TP);
* down-projections mirror that (model, data), so the TP collective
  pattern is the canonical all-reduce pair;
* under the multi-pod mesh, FSDP stays *within* a pod (axis ``data``) and
  parameters replicate across ``pod``.

Decode caches shard batch over dp and the 32k sequence (dense caches) over
``model``.

A spec is a tuple with one entry per tensor dim: ``None`` (not sharded),
a mesh axis name, or a tuple of names (the dim split over several mesh
axes, the first outermost). It is the reference's ``PartitionSpec``, with
the leading ``None`` of a leaf the reference stacks for its layer scan
dropped: the port's ``layers``, ``enc_layers``, ``dec_layers`` and
``groups`` are lists. :func:`to_placements` turns a spec into one
``Shard(d)`` or ``Replicate()`` per mesh dim, and :func:`distribute` a
tree into DTensors. A ``mesh`` here is a ``DeviceMesh`` or anything else
with ``mesh_dim_names`` and ``shape`` (:class:`MeshShape`), so the specs
can be computed without a process group.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.transformer.common import placements_for
from repro_torch.models.transformer.config import ArchConfig

DATA, MODEL = "data", "model"


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices."""
    mesh_dim_names: tuple
    shape: tuple


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """The shape of ``launch.mesh.make_production_mesh``'s mesh."""
    if multi_pod:
        return MeshShape(("pod", DATA, MODEL), (2, 16, 16))
    return MeshShape((DATA, MODEL), (16, 16))


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> tuple:
    """Batch axes: ('pod', 'data') on a multi-pod mesh, else ('data',)."""
    return ("pod", DATA) if "pod" in mesh.mesh_dim_names else (DATA,)


def dp_for_batch(mesh, batch: int):
    """The dp axis spec for a batch dim of the given size, degrading to
    replication when the batch is too small to shard (long_500k has B=1)."""
    axes = dp_axes(mesh)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    if batch % n == 0:
        return axes if len(axes) > 1 else axes[0]
    if batch % sizes[DATA] == 0:
        return DATA
    return None


# (containing key, leaf key) -> trailing-dims spec
_RULES: dict[tuple[str, str], tuple] = {
    # attention / generic linears (dicts with w/b)
    ("wq", "w"): (DATA, MODEL), ("wk", "w"): (DATA, MODEL),
    ("wv", "w"): (DATA, MODEL), ("wo", "w"): (MODEL, DATA),
    ("wq", "b"): (MODEL,), ("wk", "b"): (MODEL,), ("wv", "b"): (MODEL,),
    ("wo", "b"): (None,),
    # mlp
    ("wg", "w"): (DATA, MODEL), ("wu", "w"): (DATA, MODEL),
    ("wd", "w"): (MODEL, DATA),
    ("wg", "b"): (MODEL,), ("wu", "b"): (MODEL,), ("wd", "b"): (None,),
    # rwkv time-mix & channel-mix
    ("wr", "w"): (DATA, MODEL), ("wr", "b"): (MODEL,),
    ("ck", "w"): (DATA, MODEL), ("ck", "b"): (MODEL,),
    ("cr", "w"): (DATA, MODEL), ("cr", "b"): (MODEL,),
    ("cv", "w"): (MODEL, DATA), ("cv", "b"): (None,),
    ("w_lora_a", "w"): (DATA, None), ("w_lora_b", "w"): (None, DATA),
    # rglru
    ("w_in", "w"): (DATA, MODEL), ("w_in", "b"): (MODEL,),
    ("w_gate", "w"): (DATA, MODEL), ("w_gate", "b"): (MODEL,),
    ("wa", "w"): (DATA, MODEL), ("wa", "b"): (MODEL,),
    ("wi", "w"): (DATA, MODEL), ("wi", "b"): (MODEL,),
    ("w_out", "w"): (MODEL, DATA), ("w_out", "b"): (None,),
    # router / projections
    ("router", "w"): (DATA, None),
    ("patch_proj", "w"): (None, DATA), ("patch_proj", "b"): (None,),
}

# bare-array leaves keyed by their own name
_LEAF_RULES: dict[str, tuple] = {
    "embed": (MODEL, DATA),
    "head": (DATA, MODEL),
    "enc_pos": (None, None),
    "conv_w": (None, MODEL), "conv_b": (MODEL,),
    "lam": (MODEL,),
    "mu": (None, None), "mu_c": (None, None),
    "u": (None, None),
    "w_base": (None,),
    "gn_g": (None,), "gn_b": (None,),
    "g": (None,), "b": (None,),          # norms
    # MoE expert stacks (E, D, Fe) / (E, Fe, D): experts unsharded (60 ∤ 16),
    # FSDP on D, TP on Fe — matches the moe_forward "weights" constraint.
    "wg": (None, DATA, MODEL), "wu": (None, DATA, MODEL),
    "wd": (None, MODEL, DATA),
}


def _spec_for(path: tuple, leaf: torch.Tensor, fsdp: bool = True) -> tuple:
    """The spec of the leaf at ``path`` (dict keys and list indices): the
    rule of (parent key, leaf key), else of the leaf key, else replicated;
    right-aligned to the leaf's dims."""
    names = [str(k) if isinstance(k, str) else f"[{k}]" for k in path]
    leaf_name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    rule = _RULES.get((parent, leaf_name))
    if rule is None:
        rule = _LEAF_RULES.get(leaf_name)
    if rule is None and leaf_name in ("w", "b"):
        # generic linear under an unknown container: replicate
        rule = (None,) * (1 if leaf_name == "b" else 2)
    if rule is None:
        rule = ()
    if not fsdp:
        # TP-only: drop the data-axis (ZeRO-3) factor
        rule = tuple(None if ax == DATA else ax for ax in rule)
    ndim = leaf.dim()
    if len(rule) > ndim:       # e.g. scalar under a rule — replicate
        rule = (None,) * ndim
    return (None,) * (ndim - len(rule)) + tuple(rule)


def _map_tree(fn, node, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; other
    values (None, ints) stay as they are."""
    if isinstance(node, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
        return type(node)(_map_tree(fn, v, path + (i,))
                          for i, v in enumerate(node))
    if isinstance(node, torch.Tensor):
        return fn(path, node)
    return node


def param_pspecs(params: Any, fsdp: bool = True) -> Any:
    """The spec tree of a parameter tree (of real or ``meta`` tensors).

    ``fsdp=False`` → TP-only parameters (replicated over ``data``): for
    ≤~20B-parameter configs the parameters fit under pure TP, and dropping
    FSDP removes the per-microbatch parameter all-gather."""
    return _map_tree(lambda p, t: _spec_for(p, t, fsdp=fsdp), params)


def opt_pspecs(opt_state: Any, params_pspecs: Any) -> Any:
    """Optimizer state shards exactly like its parameter (ZeRO-1); the
    step replicates. The port's moments are flat lists in
    ``optim.leaves`` order (dict keys sorted), so their specs follow that
    order."""
    from repro_torch.optim import tree_leaves
    flat = _spec_leaves(params_pspecs)
    cls = type(opt_state)
    if hasattr(opt_state, "mu"):
        return cls(step=(), mu=list(flat), nu=list(flat))
    if hasattr(opt_state, "momentum"):
        mom = list(flat) if opt_state.momentum is not None else None
        return cls(step=(), momentum=mom)
    return [() for _ in tree_leaves(opt_state)]


def _spec_leaves(specs) -> list:
    """A spec tree's specs in ``optim.tree_leaves`` order."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


# ---------------------------------------------------------------------------
# Decode-state sharding
# ---------------------------------------------------------------------------

def _kv_cache_pspec(dp, seq_shard: bool):
    from repro_torch.models.transformer.attention import KVCache
    seq_ax = MODEL if seq_shard else None
    return KVCache(k=(dp, seq_ax, None, None), v=(dp, seq_ax, None, None),
                   pos=None)


def _first_tensor(node):
    if isinstance(node, torch.Tensor):
        return node
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, (list, tuple)):
        for v in node:
            t = _first_tensor(v)
            if t is not None and t.dim() >= 1:
                return t
    return None


def decode_state_pspecs(cfg: ArchConfig, mesh, state) -> Any:
    """Per-family cache specs over the port's ``DecodeState``: a list of
    per-layer (hybrid: per-period) caches. ``KVCache.pos`` is a host int
    and has none."""
    from repro_torch.models.transformer import encdec
    from repro_torch.models.transformer.model import DecodeState
    from repro_torch.models.transformer.rglru import RGLRUState
    from repro_torch.models.transformer.rwkv6 import RWKVState

    batch = _first_tensor(state.caches).shape[0]   # every cache is (B, ...)
    dp = dp_for_batch(mesh, batch)
    fam = cfg.family
    n = len(state.caches)

    if fam in ("dense", "moe", "vlm"):
        # seq-shard the cache only when it is actually long (windowed caches
        # are small; replicating them avoids softmax cross-shard reductions)
        seq_shard = state.caches[0].k.shape[1] >= 8192
        return DecodeState(caches=[_kv_cache_pspec(dp, seq_shard)
                                   for _ in range(n)], tail=None, enc=None)
    if fam == "ssm":
        one = RWKVState(s=(dp, MODEL, None, None), tm_x=(dp, MODEL),
                        cm_x=(dp, MODEL))
        return DecodeState(caches=[one] * n, tail=None, enc=None)
    if fam == "hybrid":
        pat = tuple(cfg.block_pattern)

        def pos_spec(kind):
            if kind == "rec":
                return RGLRUState(h=(dp, MODEL), conv=(dp, None, MODEL))
            return _kv_cache_pspec(dp, seq_shard=False)
        groups = [{"blocks": [pos_spec(k) for k in pat]} for _ in range(n)]
        tail = [pos_spec(pat[j % len(pat)])
                for j in range(len(state.tail or []))]
        return DecodeState(caches=groups, tail=tail, enc=None)
    if fam == "audio":
        seq_shard = state.caches[0].self_kv.k.shape[1] >= 8192
        one = encdec.DecLayerCache(self_kv=_kv_cache_pspec(dp, seq_shard),
                                   cross_k=(dp, None, None, None),
                                   cross_v=(dp, None, None, None))
        return DecodeState(caches=[one] * n, tail=None, enc=(dp, None, None))
    raise ValueError(fam)


def batch_pspecs(cfg: ArchConfig, mesh, batch: dict) -> dict:
    """Each input's batch dim over dp (as far as it divides), the rest
    replicated."""
    return {k: (dp_for_batch(mesh, v.shape[0]),) + (None,) * (v.dim() - 1)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def to_placements(mesh, spec: Optional[tuple]) -> list:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim: mesh axis a gets
    ``Shard(d)`` when the spec names it at tensor dim d. A dim named with
    several axes, ``("pod", "data")``, is split over them with the first
    outermost, which is the order DTensor shards in when the axes are in
    mesh order. ``None`` (no spec) replicates."""
    return placements_for(mesh, spec)


def distribute(mesh, tree: Any, specs: Any) -> Any:
    """``tree`` with every tensor leaf a DTensor on ``mesh`` placed by its
    spec in ``specs`` (a tree of the same structure), through
    ``distribute_tensor``. Every rank must hold the whole tensor (the same
    values, or ``meta``); each keeps its ``torch.chunk`` share, uneven
    shards staying uneven, and no data moves between ranks. Other leaves
    (host ints, None) pass through."""
    from torch.distributed.tensor import distribute_tensor

    def walk(node, spec):
        if isinstance(node, torch.Tensor):
            return distribute_tensor(node, mesh, to_placements(mesh, spec),
                                     src_data_rank=None)
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [walk(v, s) for v, s in zip(node, spec)]
            if hasattr(node, "_fields"):
                return type(node)(*items)
            return type(node)(items)
        return node
    return walk(tree, specs)


def distribute_opt_state(mesh, state: Any, specs: Any) -> Any:
    """The optimizer state with its moments distributed by ``specs``
    (:func:`opt_pspecs`); the step stays the host scalar the update reads
    its learning rate and bias corrections from."""
    moments = {k: getattr(state, k) for k in ("mu", "nu", "momentum")
               if getattr(state, k, None) is not None}
    return state._replace(**{k: distribute(mesh, v, getattr(specs, k))
                             for k, v in moments.items()})
