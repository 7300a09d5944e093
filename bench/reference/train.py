"""Model-centric training steps: the reference LeapGNN must equal.

LeapGNN moves the model to the features and accumulates each model's
gradient over its time steps, which changes where the work runs and not
what it computes: each iteration's gradient is the mean cross-entropy
gradient over every root of every model, on the trees the stateless
sampler draws at the iteration's seed. So the reference samples those
trees for all the iteration's roots at once, reads their rows from the
whole feature array, runs the layer equations, and applies AdamW.

``fault`` plants one fault in the reference put in the program's place,
to read what a broken program would read: ``"half_batch"`` trains on the
first half of each iteration's roots (the mean over the rest),
``"no_exchange"`` zeroes every row that lives on another shard than its
root's (the exchange between shards left out). ``tf32`` runs the matmuls
in TF32, the precision below the configuration's float32.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from bench.reference import gnn
from bench.reference.optim import AdamW
from bench.reference.sampler import sample_tree


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for this block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tree_inputs(ds, feats_dev: torch.Tensor, roots: np.ndarray, model: dict,
                seed: int, fault=None, part=None):
    """Per-hop feature rows and the root labels of one iteration's trees."""
    if fault == "half_batch":
        roots = roots[: roots.size // 2]
    hops = sample_tree(ds.graph.indptr, ds.graph.indices, roots,
                       model["num_layers"], model["fanout"], seed)
    dev = feats_dev.device
    feats = []
    for h, ids in enumerate(hops):
        x = feats_dev[torch.from_numpy(ids).to(dev)]
        if fault == "no_exchange":
            home = np.repeat(part[roots], model["fanout"] ** h)
            away = torch.from_numpy(part[ids] != home).to(dev)
            x = torch.where(away[:, None], torch.zeros_like(x), x)
        feats.append(x)
    labels = torch.from_numpy(np.asarray(ds.labels)[roots]).to(dev)
    return feats, labels


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def train_steps(ds, feats_dev: torch.Tensor, params0: dict, model: dict,
                opt_spec: dict, roots: list, seeds: list, *, tf32=False,
                fault=None, part=None) -> dict:
    """Run ``len(roots)`` model-centric AdamW steps from ``params0``.

    Returns each step's loss, each leaf's norm of the first step's clipped
    gradient (what the update was given) and of the parameters' change
    after the last step."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    opt = AdamW(params, opt_spec)
    losses, grad1 = [], None
    with matmul_precision(tf32):
        for step_roots, seed in zip(roots, seeds):
            feats, labels = tree_inputs(ds, feats_dev, step_roots, model,
                                        seed, fault, part)
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            loss = gnn.loss(leaves, model["kind"], model["num_layers"],
                            model["fanout"], feats, labels)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            for v in params.values():
                v.requires_grad_(False)
            grads = opt.clip(grads)
            if grad1 is None:
                grad1 = leaf_norms(grads)
            opt.update(params, grads)
            losses.append(float(loss.detach()))
            del feats, grads
    change = leaf_norms({k: params[k] - params0[k] for k in params})
    return {"losses": losses, "grad1": grad1, "change": change}
