"""Eight gloo ranks on the CPU, each building the port's host mesh
(``make_host_mesh(data=4, model=2)``) and summing its global rank over the
mesh's "model" and "data" groups; tests/test_torch_dryrun.py runs this
file and reads the ``rank{r}.json`` each rank writes.

    python tests/_torch_dryrun_ranks.py OUT_DIR
"""
from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing

WORLD = 8


def host_mesh_rank(rank: int, world: int, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(data=4, model=2)
        sums = {}
        for axis in mesh.mesh_dim_names:
            t = torch.tensor([float(rank)])
            dist.all_reduce(t, group=mesh.get_group(axis))
            sums[axis] = float(t)
        res = dict(shape=list(mesh.shape), names=list(mesh.mesh_dim_names),
                   device_type=mesh.device_type,
                   coordinate=list(mesh.get_coordinate()), sums=sums)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.multiprocessing.spawn(host_mesh_rank, args=(WORLD, sys.argv[1]),
                                nprocs=WORLD)
