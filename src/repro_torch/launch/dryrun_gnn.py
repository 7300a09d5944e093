"""GNN-side dry run of the port: LeapGNN's sharded iteration at pod scale,
256 shards for one pod or 512 for two, with rank 0 executed on the device.

The reference lowers and compiles its shard_map iteration for a 256- or
512-device ``data`` axis from ShapeDtypeStruct stand-ins. The port runs
eagerly, so its dry run executes rank 0's shard body. This process starts
a ``fake`` process group of n ranks (:func:`~repro_torch.launch.mesh.
init_fake_world`), builds a flat ``("data",)`` mesh over it and calls
``make_sharded_iteration(cfg, pregather=True, mesh)`` with rank 0's
arguments at the reference's stand-in shapes. Each argument is drawn from
a seeded CPU generator and then moved to the device, so the card and the
CPU see the same inputs:

* table (1, local_rows, d) and an empty cache (1, 0, d);
* ``req`` (1, n, r_max), below local_rows;
* ``hop_idx[h]`` (1, T, batch_pad·fanout^h) with T = n, below the
  workspace height local_rows + n·r_max;
* labels (1, T, batch_pad) and weights of 1.

Everything rank 0 does really runs: the exchange's gathers, the T time
steps, each gathering its layers + 1 hops with the ``gather_rows`` kernel
on CUDA, and autograd. The fake backend moves no data between ranks; the
engine's ``ShardComm`` seeds each receive buffer with its send buffer on a
fake group (loopback), so rank 0's fetched rows are rows of its own shard
at valid indices, whatever the torch version's fake backend does.

The iteration is called twice: once under the collective census and
``FlopCounterMode``, then once measured. The record,
``hopgnn.{model}.{n}shards.json`` under :data:`RESULTS_DIR`, has the
reference's keys, defined here:

* ``collectives``: the census of one iteration
  (:class:`~repro_torch.launch.dryrun.CollectiveCensus`), rank 0's output
  bytes per op. It equals ``ShardComm``'s own count and bytes
  (``shard_comm``);
* ``memory.argument_size_in_bytes``: the bytes of the tensors rank 0 is
  handed (parameters, table, cache, plan arrays, denom);
  ``output_size_in_bytes``: the gradient leaves plus the loss;
  ``temp_size_in_bytes``: ``torch.cuda.max_memory_allocated()`` over the
  measured call, less what was allocated before it (null on the CPU,
  which keeps no allocator statistics);
* ``flops``: ``FlopCounterMode``'s total over one call, the matmuls of
  every step's forward and backward.

Neither ``memory`` nor ``flops`` is the XLA figure of the same name: XLA's
memory analysis is the compiled program's buffer assignment, and its cost
analysis counts the T-step scan body once. The record adds rank 0's time
for the measured call (``iteration_ms``, CUDA events on the card), the
kernels launched in it, whether the fake backend wrote the receive buffer
of a probe all_to_all, and ``obs/export``'s manifest.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn --device cpu \\
        --batch-pad 4 --r-max 256 --feature-dim 128 --hidden 32
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.distributed import make_sharded_iteration
from repro_torch.core.tree import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.kernels import gather_agg as _cuda
from repro_torch.kernels import sample_tree as _sample
from repro_torch.launch.dryrun import RESULTS_DIR, CollectiveCensus
from repro_torch.launch.mesh import init_fake_world
from repro_torch.models.gnn import GNNConfig, init_gnn
from repro_torch.obs.export import run_manifest

NUM_CLASSES = 47


def shard_args(cfg: GNNConfig, n: int, *, batch_pad: int, local_rows: int,
               r_max: int, device, seed: int = 0,
               pregather: bool = True) -> tuple:
    """Rank 0's ``(params, table, cache, dev, denom)`` at the stand-in
    shapes, with the shard axis kept at size 1. Per-step mode carries
    ``step_req`` (1, T, n, r_max) in place of ``req``. ``denom`` is the
    true global batch: every shard's weights are 1, so n·T·batch_pad."""
    g = torch.Generator().manual_seed(seed)
    params = init_gnn(cfg, generator=g, device=device)
    T, d = n, cfg.feature_dim

    def ints(hi: int, shape: tuple) -> torch.Tensor:
        return torch.randint(0, hi, shape, generator=g,
                             dtype=torch.int32).to(device)

    table = torch.randn((1, local_rows, d), generator=g).to(device)
    cache = torch.zeros((1, 0, d), device=device)
    req = ints(local_rows, (1, n, r_max) if pregather else (1, T, n, r_max))
    height = local_rows + n * r_max
    dev = {"req": req if pregather else None,
           "step_req": None if pregather else req,
           "hop_idx": [ints(height, (1, T, batch_pad * cfg.fanout ** h))
                       for h in range(cfg.num_layers + 1)],
           "labels": ints(cfg.num_classes, (1, T, batch_pad)),
           "weights": torch.ones((1, T, batch_pad), device=device)}
    denom = torch.tensor(float(n * T * batch_pad), device=device)
    return params, table, cache, dev, denom


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _fake_writes_receive_buffer(device) -> bool:
    """Whether the fake backend writes an all_to_all's receive buffer: the
    send buffer is 0..n-1 and the receive buffer -1 beforehand."""
    n = dist.get_world_size()
    x = torch.arange(n, dtype=torch.float32, device=device)
    out = torch.full_like(x, -1.0)
    dist.all_to_all_single(out, x)
    return bool(torch.equal(out, x))


def run(n: int, *, model: str = "sage", layers: int = 3, fanout: int = 10,
        feature_dim: int = 600, hidden: int = 128, batch_pad: int = 8,
        local_rows: int = 16384, r_max: int = 2048, device=None,
        seed: int = 0, pregather: bool = True, fold_returns: bool = False,
        results_dir: Optional[Path] = RESULTS_DIR) -> tuple:
    """Rank 0 of an n-shard iteration on a fake world (T = n steps).
    Returns ``(record, grads, loss)``, the last two from the measured
    call; writes the record under ``results_dir`` unless it is None. The
    fake world is started here and destroyed before returning."""
    device = resolve_device(device)
    cfg = GNNConfig(model=model, num_layers=layers, hidden_dim=hidden,
                    feature_dim=feature_dim, num_classes=NUM_CLASSES,
                    fanout=fanout)
    init_fake_world(n, device.type)
    try:
        mesh = init_device_mesh(device.type, (n,), mesh_dim_names=("data",))
        args = shard_args(cfg, n, batch_pad=batch_pad, local_rows=local_rows,
                          r_max=r_max, device=device, seed=seed,
                          pregather=pregather)
        fn = make_sharded_iteration(cfg, pregather, mesh,
                                    fold_returns=fold_returns)
        comm = fn.comm
        writes = _fake_writes_receive_buffer(device)

        def comm_delta(before: tuple) -> dict:
            return {"counts": {k: v - before[0][k]
                               for k, v in comm.counts.items()},
                    "nbytes": {k: v - before[1][k]
                               for k, v in comm.nbytes.items()}}

        before = (dict(comm.counts), dict(comm.nbytes))
        with CollectiveCensus() as census, \
                FlopCounterMode(display=False) as flop_counter:
            fn(*args)
        counted = comm_delta(before)

        cuda = device.type == "cuda"
        launched = {**_cuda.launches, **_sample.launches}
        before = (dict(comm.counts), dict(comm.nbytes))
        if cuda:
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            grads, loss = fn(*args)
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end)
            temp = torch.cuda.max_memory_allocated(device) - base
        else:
            t0 = time.perf_counter()
            grads, loss = fn(*args)
            ms = (time.perf_counter() - t0) * 1e3
            temp = None
        launches = {k: v - launched[k]
                    for k, v in {**_cuda.launches, **_sample.launches}.items()}
        if comm_delta(before) != counted:
            raise AssertionError(f"the measured call's collectives "
                                 f"{comm_delta(before)} differ from the "
                                 f"counted call's {counted}")
    finally:
        dist.destroy_process_group()

    params, table, cache, dev, denom = args
    arg_bytes = _nbytes(params.leaves() + [table, cache, denom]
                        + tree_leaves(dev))
    rec = {
        "kind": "hopgnn_gnn_iteration",
        "mesh": f"{n}x1(data)",
        "model": model,
        "status": "ok",
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": _nbytes(list(grads) + [loss]),
                   "temp_size_in_bytes": temp},
        "flops": float(flop_counter.get_total_flops()),
        "collectives": census.result(),
        "shard_comm": counted,
        "world": n,
        "shapes": dict(layers=layers, fanout=fanout,
                       feature_dim=feature_dim, hidden=hidden,
                       batch_pad=batch_pad, local_rows=local_rows,
                       r_max=r_max, pregather=pregather,
                       fold_returns=fold_returns),
        "device": str(device),
        "iteration_ms": ms,
        "launches": launches,
        "fake_all_to_all_writes_receive_buffer": writes,
        "loss": float(loss),
        "manifest": run_manifest(seed=seed),
    }
    if results_dir is not None:
        results_dir = Path(results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)
        out = results_dir / f"hopgnn.{model}.{n}shards.json"
        out.write_text(json.dumps(rec, indent=1))
    return rec, grads, loss


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--model", default="sage")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--feature-dim", type=int, default=600)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--batch-pad", type=int, default=8)
    ap.add_argument("--local-rows", type=int, default=16384)
    ap.add_argument("--r-max", type=int, default=2048)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--results-dir", type=Path, default=RESULTS_DIR)
    args = ap.parse_args(argv)
    n = 512 if args.multi_pod else 256
    rec, _, _ = run(n, model=args.model, layers=args.layers,
                    fanout=args.fanout, feature_dim=args.feature_dim,
                    hidden=args.hidden, batch_pad=args.batch_pad,
                    local_rows=args.local_rows, r_max=args.r_max,
                    device=args.device, seed=args.seed,
                    results_dir=args.results_dir)
    temp = rec["memory"]["temp_size_in_bytes"]
    coll = rec["collectives"]
    print(f"[ok] hopgnn {args.model} iteration on {n}-shard mesh: temp "
          f"{'n/a' if temp is None else f'{temp / 1e9:.2f}'} GB/dev, "
          f"collectives {coll['total_bytes'] / 1e9:.2f} GB "
          f"({coll['count_by_op']})")
    print(f"rank 0: {rec['iteration_ms']:.3f} ms for {rec['world']} steps on "
          f"{rec['device']}, flops {rec['flops']:.6g}, kernel launches "
          f"{rec['launches']}, record "
          f"{args.results_dir / f'hopgnn.{args.model}.{n}shards.json'}")


if __name__ == "__main__":
    main()
