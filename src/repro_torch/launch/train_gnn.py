"""LeapGNN training driver on the port (the counterpart of
``examples/train_hopgnn.py``).

Synthetic products dataset → community partition → the compile-once
Trainer (shape budget, plan prefetch, redistribution, pre-gathering,
adaptive merging, the async pipeline) → AdamW with a cosine schedule →
eval each epoch, with a crash-atomic checkpoint at each epoch boundary
under ``--ckpt-dir`` (default: ``hopgnn_torch_ckpt`` in the system's temp
directory). Epoch 0 carries the first call of each new shape signature;
epochs ≥ 1 run with none (the closing "compile-once" line). ``--resume``
continues from the newest checkpoint, and says "nothing to do" when it
already covers every epoch.

Presets:
  --preset smoke   a few seconds on a CPU (default)
  --preset 100m    ~100M-parameter GraphSAGE (dim 600, hidden 4096), sized
                   for the GPU

    PYTHONPATH=src python -m repro_torch.launch.train_gnn --preset smoke \\
        --device cpu [--ckpt-dir DIR] [--resume]

Under torchrun the launcher trains over a device mesh, one process per
shard: it reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, joins a
process group (NCCL on CUDA, gloo only with ``--device cpu``; a mismatched
collective fails after ``PG_TIMEOUT_S`` seconds instead of hanging),
builds a 1-D ``DeviceMesh`` over the ``"data"`` axis and requires
``--shards == WORLD_SIZE``. Every rank builds the same dataset and plans;
rank 0 prints and writes the checkpoints. Without torchrun's environment
all shards are emulated on one device, as above.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
        repro_torch.launch.train_gnn --preset smoke --device cpu
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.core import distributed as engine
from repro_torch.graph import make_dataset
from repro_torch.graph.partition import community_partition, shard_features
from repro_torch.models.gnn import GNNConfig, init_gnn, model_param_bytes
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import Trainer

PG_TIMEOUT_S = 120   # a collective that waits longer fails the run

PRESETS = {
    "smoke": dict(scale=0.03, hidden=64, fanout=4, layers=2, batch=16,
                  epochs=3, iters=8, dim=None),
    "100m": dict(scale=0.3, hidden=4096, fanout=10, layers=3, batch=256,
                 epochs=10, iters=30, dim=600),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="smoke", choices=PRESETS)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--strategy", default="hopgnn",
                    choices=["hopgnn", "model_centric", "lo"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "hopgnn_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="per-iteration blocking loop instead of the async "
                         "fused pipeline")
    ap.add_argument("--stack", type=int, default=1,
                    help="K plans per dispatch (amortizes dispatch overhead "
                         "when device iterations are tiny)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    P = PRESETS[args.preset]
    mesh = join_mesh(args) if "WORLD_SIZE" in os.environ else None
    say = print if mesh is None or dist.get_rank() == 0 else (
        lambda *a, **k: None)

    ds = make_dataset("products", scale=P["scale"], seed=0,
                      feat_dim=P["dim"])
    part = community_partition(ds.communities, args.shards)
    table, owner, local_idx = shard_features(ds.features, part, args.shards)
    cfg = GNNConfig(model="sage", num_layers=P["layers"],
                    hidden_dim=P["hidden"], feature_dim=ds.feature_dim,
                    num_classes=ds.num_classes, fanout=P["fanout"])
    params = init_gnn(cfg, torch.Generator().manual_seed(0),
                      "cpu" if mesh is not None else args.device)
    say(f"dataset: {ds.num_vertices} vertices; model: "
          f"{model_param_bytes(params) / 1e6:.1f} MB params "
          f"({model_param_bytes(params) / 4 / 1e6:.1f}M) on "
          + (f"{next(params.parameters()).device}" if mesh is None else
             f"a {mesh.device_type} mesh of {mesh.size()} ranks"))

    total = P["epochs"] * P["iters"]
    opt = adamw(cosine_schedule(3e-3, warmup=10, total=total),
                weight_decay=1e-4, grad_clip=1.0,
                key=("cos", 3e-3, 10, total))   # value identity for the
    #             engine's fused-step cache (a schedule is not comparable)
    trainer = Trainer(
        graph=ds.graph, labels=ds.labels, part=part, owner=owner,
        local_idx=local_idx, table=table, cfg=cfg, optimizer=opt,
        params=params, strategy=args.strategy,
        train_vertices=ds.train_vertices(), ckpt_dir=args.ckpt_dir,
        pipeline=not args.no_pipeline, pipeline_stack=args.stack,
        device=args.device, mesh=mesh)

    tc0 = engine.trace_count()
    stats = trainer.fit(epochs=P["epochs"], iters_per_epoch=P["iters"],
                        batch_per_model=P["batch"] // args.shards,
                        eval_every=1, resume=args.resume, log=print)
    if mesh is not None:
        dist.destroy_process_group()
    if not stats:
        say("nothing to do: checkpoint already covers every epoch "
              f"(step {trainer.global_step})")
        return
    first, rest = stats[0], stats[1:]
    if rest:
        say(f"compile-once: epoch 0 {first.time_s:.2f}s "
              f"(incl. first calls) vs epochs>=1 mean "
              f"{sum(s.time_s for s in rest) / len(rest):.2f}s; "
              f"{engine.trace_count() - tc0} traces total, "
              f"{sum(s.traces for s in rest)} after epoch 0, "
              f"budget {trainer.budget.signature()} "
              f"({trainer.budget.rebuckets} rebuckets)")
        if first.pipelined:
            say(f"pipeline: steady "
                  f"{1000 * rest[-1].steady_time_s / P['iters']:.1f} ms/iter "
                  f"(synced window), dispatch "
                  f"{1000 * rest[-1].dispatch_s / P['iters']:.1f} ms/iter, "
                  f"{trainer._uploader.uploads} committed uploads, "
                  f"{trainer._uploader.shape_changes} shape changes")
    say(f"done; checkpoints in {args.ckpt_dir}")


def join_mesh(args):
    """Under torchrun: this process's place in a 1-D mesh of WORLD_SIZE
    ranks over the ``"data"`` axis, one rank per shard."""
    from torch.distributed.device_mesh import init_device_mesh
    world = int(os.environ["WORLD_SIZE"])
    if args.shards != world:
        raise SystemExit(f"--shards {args.shards} must equal WORLD_SIZE "
                         f"{world}: one process per shard")
    device_type = torch.device(args.device or "cuda").type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is available; pass --device "
                             "cpu to train over gloo on the CPU")
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise SystemExit(f"no process-group backend for {device_type}")
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return init_device_mesh(device_type, (world,), mesh_dim_names=("data",))


if __name__ == "__main__":
    main()
