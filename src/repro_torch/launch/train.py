"""Training step assembly for the transformer side workload.

The port of the reference's ``launch/train.py``. ``make_train_step(cfg,
opt, accum)`` returns a function

    (params, opt_state, batch) -> (params, opt_state, metrics)

that runs eagerly on the parameters' device: ``torch.autograd.grad`` over
:func:`repro_torch.models.transformer.loss_fn`, then the optimizer's update
in place. The reference's ``jax.jit`` has no counterpart (no
``torch.compile``). Run as a module for a small training loop, on ``cuda``
unless told otherwise:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --device cpu
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.models.transformer.common import _dtensor
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.optim import Optimizer, adamw, leaves


def pick_optimizer(cfg: ArchConfig, lr: float = 1e-4) -> Optimizer:
    """AdamW; bf16 moments above 100B params (nemotron's memory budget)."""
    big = cfg.param_count() > 100e9
    return adamw(lr, weight_decay=0.1, grad_clip=1.0,
                 state_dtype=torch.bfloat16 if big else torch.float32)


def pick_accum(cfg: ArchConfig, global_batch: int) -> int:
    """Gradient-accumulation microbatch count: 16 above 100B parameters, 4
    above 8B, else 1, halved until it divides ``global_batch``.
    Microbatching divides peak activation memory by the factor at no extra
    FLOPs."""
    n = cfg.param_count()
    if n > 100e9:
        accum = 16
    elif n > 8e9:
        accum = 4
    else:
        return 1
    while global_batch % accum:
        accum //= 2
    return max(accum, 1)


def _with_leaves(node, it):
    """``node``'s tree (dicts and lists) with its leaves taken from ``it``
    in :func:`repro_torch.optim.leaves` order."""
    if isinstance(node, dict):
        return {k: _with_leaves(node[k], it) for k in sorted(node)}
    if isinstance(node, list):
        return [_with_leaves(v, it) for v in node]
    return next(it)


def _microbatch(v: torch.Tensor, accum: int, i: int) -> torch.Tensor:
    """Rows [i·B/accum, (i+1)·B/accum) of v. A DTensor whose batch dim
    is sharded is gathered over it first (DTensor cannot split a sharded
    batch into (accum, B/accum) when accum does not divide into the
    shards; GSPMD moves the rows with an all-to-all), and the microbatch
    sharded as v was over as many of those mesh axes as its rows divide
    into, the outermost dropped first (the reference's ``dp_for_batch``:
    16 rows over ("pod", "data") shard over "data" alone)."""
    mb_rows = v.shape[0] // accum
    if _dtensor(v) and any(pl.is_shard() and pl.dim == 0
                           for pl in v.placements):
        from torch.distributed.tensor import Replicate
        mesh, placements = v.device_mesh, list(v.placements)
        whole = v.redistribute(mesh, [
            Replicate() if pl.is_shard() and pl.dim == 0 else pl
            for pl in placements])
        mb = whole.reshape(accum, mb_rows, *v.shape[1:])[i]
        dims = [d for d, pl in enumerate(placements)
                if pl.is_shard() and pl.dim == 0]
        while dims and mb_rows % math.prod(mesh.size(d) for d in dims):
            placements[dims.pop(0)] = Replicate()
        return mb.redistribute(mesh, placements)
    return v.reshape(accum, mb_rows, *v.shape[1:])[i]


def value_and_grad(params, cfg: ArchConfig, batch: dict):
    """(loss, {"ce", "aux"}, grads): grads a list aligned with
    ``leaves(params)``, each in its parameter's dtype (zeros for a leaf the
    loss does not reach, as ``jax.grad`` gives). The parameters are
    differentiated through detached aliases, so their own ``requires_grad``
    stays as it was."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss, parts = loss_fn(_with_leaves(params, iter(live)), cfg, batch)
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            list(grads))


def accumulated_grads(params, cfg: ArchConfig, batch: dict, accum: int = 1):
    """(loss, {"ce", "aux"}, grads) of ``batch``; with ``accum`` > 1 the
    batch is split into ``accum`` microbatches and their results summed in
    a Python-unrolled loop, as the reference does: loss, parts and
    gradients each accumulated as ``acc + x / accum`` from zeros."""
    if accum == 1:
        return value_and_grad(params, cfg, batch)

    def slice_mb(i):
        return {k: _microbatch(v, accum, i) for k, v in batch.items()}
    dev = params["embed"].device
    loss = torch.zeros((), device=dev)
    parts = {"ce": torch.zeros((), device=dev),
             "aux": torch.zeros((), device=dev)}
    grads = [torch.zeros_like(p) for p in leaves(params)]
    for i in range(accum):
        l_i, p_i, g_i = value_and_grad(params, cfg, slice_mb(i))
        loss = loss + l_i / accum
        parts = {k: parts[k] + p_i[k] / accum for k in parts}
        grads = [a + b / accum for a, b in zip(grads, g_i)]
    return loss, parts, grads


def make_train_step(cfg: ArchConfig, opt: Optimizer, accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    :func:`accumulated_grads` of the batch, then the optimizer's update in
    place. ``metrics`` holds 0-d tensors ``loss``, ``ce`` and ``aux`` on the
    device."""
    def train_step(params, opt_state, batch):
        loss, parts, grads = accumulated_grads(params, cfg, batch, accum)
        params, opt_state = opt.update(grads, opt_state, params)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"]}
        return params, opt_state, metrics
    return train_step


def init_all(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Parameters drawn on ``device`` (default ``cuda``) from a generator
    seeded with ``seed``."""
    device = resolve_device(device)
    return init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                       device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant (CPU-sized)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import token_batches

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    device = resolve_device(args.device)
    opt = pick_optimizer(cfg, lr=3e-4)
    params = init_all(cfg, device=device)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    print(f"arch={cfg.name} device={device} batch {args.batch} x seq "
          f"{args.seq}", flush=True)
    for i, batch in enumerate(token_batches(cfg, args.batch, args.seq,
                                            steps=args.steps, seed=0)):
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss = float(m["loss"])
        print(f"step {i:4d} loss {loss:.4f} "
              f"({time.perf_counter() - t0:.2f}s)", flush=True)


if __name__ == "__main__":
    main()
