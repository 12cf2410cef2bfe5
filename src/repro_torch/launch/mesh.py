"""Device meshes.

Counterpart of ``repro.launch.mesh``. ``make_mesh`` builds a
``torch.distributed`` ``DeviceMesh``; a process that has no process group
yet gets a world of one (gloo on the CPU, NCCL on the card) over an
in-process store, so the single-device CLIs and the tests need no
address or launcher. A mesh larger than the world needs the caller's
process group (``torch.distributed.init_process_group`` with its address,
world size and rank).

``make_production_mesh`` is the reference's 16 x 16 mesh, or 2 x 16 x 16
over pods, built on torch's ``fake`` process group: one process holds every
rank, collectives do nothing, and shapes, placements and the sharded
steps' structure can be worked out at production size on one host. A
process has one default group, so it refuses when a group of another
backend is already up, and does not tear that group down.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh: (16, 16) over ("data", "model"), or (2, 16, 16) over
    ("pod", "data", "model"), of CPU devices on a ``fake`` process group of that
    many ranks (started here if the process has none; one already up is reused if
    it is ``fake`` and has as many ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = math.prod(shape)
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(f"make_production_mesh needs the 'fake' process group, but a "
                               f"{backend!r} group is up; destroy it first")
        if dist.get_world_size() < world:
            raise RuntimeError(f"the fake group has {dist.get_world_size()} ranks; the "
                               f"production mesh needs {world}")
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


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
