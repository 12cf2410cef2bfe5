"""Device meshes.

Counterpart of ``repro.launch.mesh``. ``make_mesh`` builds a
``torch.distributed`` ``DeviceMesh``; a process that has no process group
yet gets a world of one (gloo on the CPU, NCCL on the card) over an
in-process store, so the single-device CLIs and the tests need no
address or launcher. A mesh larger than the world needs the caller's
process group (``torch.distributed.init_process_group`` with its address,
world size and rank).

The reference's ``make_production_mesh`` (16 x 16, or 2 x 16 x 16 over
pods) waits for the sharded step (ROADMAP A8), on torch's fake process
group.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` on ``device_type``
    devices; starts a world of one if the process has no process group."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise ValueError(f"a mesh of {math.prod(shape)} devices needs a process group of "
                             "that many ranks: call torch.distributed.init_process_group first")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_devices(mesh: DeviceMesh) -> int:
    return int(mesh.size())
