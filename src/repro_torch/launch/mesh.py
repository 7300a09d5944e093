"""Device meshes of the port: the production pod mesh and a small host
mesh.

Functions, not module-level constants: importing this module starts no
process group and touches no device, as the reference never sets
``XLA_FLAGS`` on import (a test that imports every module must not change
any other test's world).

The production mesh is 16×16 (one pod, 256 chips) or 2×16×16 (two pods,
512). Without that many cards it is built over a ``fake`` process group:
this process is rank 0 of the world, and every collective it issues
returns without reaching another process (:func:`init_fake_world`).
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def init_fake_world(world: int, device_type: str = "cuda") -> None:
    """Start a ``fake`` default process group as rank 0 of ``world`` ranks,
    for tensors on ``device_type`` (``cuda`` raises without a GPU).

    The only place in the port that touches
    ``torch.testing._internal.distributed.fake_pg``: importing it registers
    the ``fake`` backend. A fake collective moves no data between ranks.
    Raises RuntimeError when this process already has a default group (a
    process has one at a time; destroy it first) or when the installed
    torch has no fake backend."""
    resolve_device(device_type)
    if dist.is_initialized():
        raise RuntimeError(
            f"a default process group ({dist.get_backend()}, "
            f"{dist.get_world_size()} ranks) already exists in this "
            f"process; destroy it before starting a fake world")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this torch has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg)"
                           ) from e
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def _mesh(device_type: str, shape: tuple, axes: tuple) -> DeviceMesh:
    world = math.prod(shape)
    if not dist.is_initialized():
        init_fake_world(world, device_type)
    elif dist.get_world_size() != world:
        raise ValueError(f"a mesh of shape {shape} needs {world} ranks; the "
                         f"default group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16×16 single pod (256 ranks) or 2×16×16 two-pod (512 ranks), axes
    ("data", "model") or ("pod", "data", "model"). Over the default group
    when it has that many ranks; without a default group, over a fake world
    started here (:func:`init_fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(data: int = 4, model: int = 2,
                   device_type: str = "cpu") -> DeviceMesh:
    """Small (data, model) mesh for integration tests, over an existing
    world of ``data·model`` ranks (gloo on the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError(f"make_host_mesh needs a process group of "
                           f"{data * model} ranks; none is initialized")
    return _mesh(device_type, (data, model), ("data", "model"))
