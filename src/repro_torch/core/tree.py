"""Trees of tensors in ``jax.tree.leaves`` order, without JAX.

The port keeps its parameters in a GNN module, its optimizer state in
NamedTuples of lists, and groups them in dicts. The engine (signatures),
the optimizer's snapshot and the checkpoint layer (leaf numbering shared
with the reference) all walk such trees in the order ``jax.tree.leaves``
gives: dict keys sorted, NamedTuple fields in order, lists in order, None
an empty subtree, and a GNN module by its :meth:`leaves`.
"""
from __future__ import annotations

from typing import Any

import torch


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def is_module(x) -> bool:
    return isinstance(x, torch.nn.Module) and hasattr(x, "leaves")


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts, NamedTuples, lists/tuples and GNN
    modules, in ``jax.tree.leaves`` order (None is an empty subtree)."""
    if tree is None:
        return []
    if is_module(tree):
        return list(tree.leaves())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_clone(tree: Any) -> Any:
    """Clones of every tensor of a tree of NamedTuples, lists and dicts
    (the optimizer states); anything else is shared."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if is_namedtuple(tree):
        return type(tree)(*[tree_clone(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_clone(v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    return tree
