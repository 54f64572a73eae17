"""Device meshes over ``torch.distributed`` process groups.

The counterpart of the reference's ``launch/mesh.py``:

- ``make_production_mesh(multi_pod=)``: (data=16, model=16), 256 devices,
  or (pod=2, data=16, model=16), 512; real under ``torchrun`` at that
  world size, or over the fake process group of the dry run
  (``launch/dryrun.py``);
- ``make_mesh(shape, axes)``: any mesh whose size is the group's world
  size;
- ``make_host_mesh()``: (world size, 1) over ("data", "model"); in one
  process that is a group of world size 1, NCCL on the card, gloo on the
  CPU.

A mesh whose size differs from the process group's world size raises; there
is no fallback to a meshless run. The process group is set up and torn
down here only (``init_group``, ``destroy_group``), so a
process can use one group kind after another (the tests, ``chip_smoke.py``).
The sharding code reads a mesh's axis names and sizes through
``axis_sizes``, which also takes the reference's kind of mesh stub
(``axis_names`` and ``devices`` of the mesh's shape).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a stub with
    ``axis_names`` and ``devices``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def init_group(backend: str, world_size: int = 1, rank: int = 0) -> None:
    """Set up the default process group.

    ``backend`` is "nccl", "gloo" or "fake" (the dry run's: every
    collective returns at once, no data moves). A group of world size 1 is
    kept in an in-process store; larger real groups read ``torchrun``'s
    environment. Raises if a group is already set up."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group ({dist.get_backend()}, world size "
            f"{dist.get_world_size()}) is already set up; destroy_group() "
            "first")
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size)
    elif world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        if "MASTER_ADDR" not in os.environ:
            raise RuntimeError(
                f"a {backend} group of world size {world_size} needs "
                "torchrun's environment (MASTER_ADDR, RANK, WORLD_SIZE)")
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size)


def destroy_group() -> None:
    """Tear down the default process group and its sub-groups, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _ensure_group(device: str, size: int) -> None:
    """Set up a group for a mesh of ``size`` devices if none is: world
    size 1 in this process, or torchrun's world."""
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != size:
        raise RuntimeError(
            f"a mesh of {size} devices needs a process group of world size "
            f"{size}; this process has none (WORLD_SIZE={world}): run it "
            f"under torchrun --nproc-per-node ... at {size} ranks")
    init_group(BACKENDS[torch.device(device).type], world,
               int(os.environ.get("RANK", 0)))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group
    (set up here if there is none and the mesh has one device, or under
    torchrun). Raises if the mesh's size is not the group's world size."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    size = math.prod(shape)
    _ensure_group(device, size)
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has {size} devices "
                         f"but the process group has world size {world}")
    dev_type = ("cpu" if dist.get_backend() in ("fake", "gloo")
                else torch.device(device).type)
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``: 256 or 512 ranks, never fewer."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device)


def make_host_mesh(device: str = "cuda"):
    """(world size, 1) over ("data", "model"): in one process, one device
    (NCCL on "cuda", gloo on "cpu")."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    return make_mesh((world, 1), ("data", "model"), device)

