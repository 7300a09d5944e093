"""Eight gloo ranks on the CPU over the port's host mesh
(``make_host_mesh(data=4, model=2)``), each running one sharded train step
and the prefill logits of several smoke models with the parameters,
optimizer state and batch placed by ``launch/sharding.py``, and the same
step on plain tensors; tests/test_torch_sharding.py runs this file and
reads the ``rank{r}.json`` each rank writes (and rank 0's
``{variant}.pt``).

    python tests/_torch_sharding_ranks.py OUT_DIR [REFERENCE_PARAMS.pt]

REFERENCE_PARAMS.pt, when given, holds the reference's converted
parameters of the variant named in it, used in place of the port's init.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing

WORLD = 8
BATCH, SEQ = 8, 32
# the step's optimizer: plain SGD, so the parameters after the step hold
# the gradient to the same bound (AdamW's first step divides each element
# by its own |g|: an element whose |g| is near eps moves by a share of lr
# that the float32 rounding of g decides, up to 9e-3 of a leaf's max
# here; AdamW over DTensors runs in the dry run and on the card)
LR = 0.1
# (variant, arch, overrides of the smoke variant). The first runs with the
# carry's sequence sharded over TP (the default); the others without it:
# a sequence shard under a batch shard makes every matmul's flattened rows
# a strided shard, whose redistributions DTensor plans by a graph search
# that costs each rank seconds per new shape.
SEQ_SHARDED = "qwen2-1.5b"
VARIANTS = [
    ("qwen2-1.5b", "qwen2-1.5b", {}),
    ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", {}),
    ("rwkv6-7b", "rwkv6-7b", {}),
    ("recurrentgemma-9b", "recurrentgemma-9b", {}),
    ("pixtral-12b", "pixtral-12b", {}),
    ("whisper-base", "whisper-base", {}),
    # 3 query heads (and one kv head): they do not divide the 2 TP shards
    ("qwen2-1.5b-3heads", "qwen2-1.5b",
     dict(num_heads=3, num_kv_heads=1, head_dim=64)),
]


def variant_config(name: str):
    from repro_torch.configs import get_config, smoke_variant
    arch, kw = next((a, k) for n, a, k in VARIANTS if n == name)
    return dataclasses.replace(smoke_variant(get_config(arch)), **kw)


def perturbed(params: dict, seed: int = 0) -> dict:
    """The parameters with the leaves a fresh init sets to constants drawn
    from a seeded generator: biases, RWKV6's bonus and group-norm shift
    and conv biases ~ 0.1·N(0, 1), norm gains 1 + 0.1·N(0, 1), token-shift
    mixes ~ U(0, 1), RG-LRU's Λ ~ U(1, 3). A constant leaf would hide a
    wrong gradient, and a zero one turns a bound of its largest |value|
    into one of its update alone."""
    g = torch.Generator().manual_seed(seed)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        shape = node.shape
        if name in ("b", "u", "gn_b", "conv_b"):
            new = 0.1 * torch.randn(shape, generator=g)
        elif name in ("g", "gn_g"):
            new = 1 + 0.1 * torch.randn(shape, generator=g)
        elif name in ("mu", "mu_c"):
            new = torch.rand(shape, generator=g)
        elif name == "lam":
            new = 1 + 2 * torch.rand(shape, generator=g)
        else:
            return node
        return new.to(node.dtype)
    return walk(params)


def _prefill_logits(params, cfg, batch):
    """``forward_hidden``, then the last position's logits. Autograd
    records, as in the train step's forward, so the sharded step after it
    reuses DTensor's sharding decisions (a cold one costs seconds per
    op shape on every rank); the values are those of a no-grad call."""
    from repro_torch.models.transformer.model import (_head_matrix,
                                                      forward_hidden)
    with torch.enable_grad():
        x, _ = forward_hidden(params, cfg, batch)
        return (x[:, -1] @ _head_matrix(params)).detach()


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _share(got, want) -> float:
    """max |got - want| over max |want| (0 where both are all zero)."""
    got, want = _full(got).detach().float(), want.detach().float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


def run_variant(name: str, mesh, reference: dict) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data import make_batch
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import sgd, tree_leaves

    from repro_torch.models.transformer.model import set_sequence_sharding
    t0 = time.perf_counter()
    set_sequence_sharding(name == SEQ_SHARDED)
    cfg = variant_config(name)
    if name in reference:
        params = reference[name]
    else:
        params = perturbed(init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu"))
    batch = make_batch(cfg, BATCH, SEQ, seed=0)
    opt = sgd(LR)
    step = make_train_step(cfg, opt)

    plain = copy.deepcopy(params)
    logits = _prefill_logits(plain, cfg, batch)
    plain, _, m_plain = step(plain, opt.init(plain), batch)

    specs = shd.param_pspecs(params)
    d_params = shd.distribute(mesh, copy.deepcopy(params), specs)
    state = opt.init(params)
    d_state = shd.distribute_opt_state(mesh, state,
                                       shd.opt_pspecs(state, specs))
    d_batch = shd.distribute(mesh, batch, shd.batch_pspecs(cfg, mesh, batch))
    t1 = time.perf_counter()
    with implicit_replication():
        d_logits = _prefill_logits(d_params, cfg, d_batch)
        t2 = time.perf_counter()
        d_params, _, m = step(d_params, d_state, d_batch)
    t3 = time.perf_counter()

    coord = mesh.get_coordinate()
    got, want = tree_leaves(d_params), tree_leaves(plain)
    shards = []
    for t in got:
        key = [[i, coord[i]] for i, pl in enumerate(t.placements)
               if pl.is_shard()]
        local = t.to_local().detach().contiguous()
        shards.append([key, hashlib.sha1(local.numpy().tobytes())
                       .hexdigest()])
    out = {"loss": _share(m["loss"], m_plain["loss"]),
           "loss_value": float(_full(m["loss"])),
           "logits": _share(d_logits, logits),
           "params": max(_share(a, b) for a, b in zip(got, want)),
           "leaves": len(got), "shards": shards,
           "seconds": [t1 - t0, t2 - t1, t3 - t2]}
    if name in reference:
        whole = {"loss": _full(m["loss"]).detach(),    # collectives: every
                 "params": [_full(t).detach() for t in got]}   # rank joins
        out["saved"] = f"{name}.pt"
        if dist.get_rank() == 0:
            torch.save(whole, os.path.join(OUT[0], out["saved"]))
    return out


OUT = [""]


def sharding_rank(rank: int, world: int, out_dir: str, ref_path: str) -> None:
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer.common import set_mesh_axes
    torch.set_num_threads(1)
    OUT[0] = out_dir
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(data=4, model=2)
        set_mesh_axes(dp=("data",), tp=("model",))
        reference = torch.load(ref_path) if ref_path else {}
        res = {name: run_variant(name, mesh, reference)
               for name, _, _ in VARIANTS}
        res["coordinate"] = list(mesh.get_coordinate())
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.multiprocessing.spawn(
        sharding_rank,
        args=(WORLD, sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else ""),
        nprocs=WORLD)
