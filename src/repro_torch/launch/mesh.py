"""Device meshes over ``torch.distributed``.

Functions, not module-level meshes: importing this module starts no
process group. A caller that runs several processes initialises the group
itself (``torch.distributed.init_process_group`` with an address, a world
size and a rank); these functions build the mesh over it.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from ..device import resolve_device

#: The reference's production meshes: one pod of 16 x 16 chips, and two.
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _ensure_group(device) -> str:
    """The device type of the mesh; starts a one-process group on a
    ``HashStore`` (NCCL on CUDA, gloo on the CPU) where none is
    initialised."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev.type


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device="cuda"):
    """A mesh of ``shape`` named ``names`` over the initialised process
    group (a one-process group is started where there is none); raises if
    the world size is not the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = _ensure_group(device)
    world, size = dist.get_world_size(), math.prod(shape)
    if world != size:
        raise ValueError(f"a {shape} mesh {names} needs {size} processes; "
                         f"the process group has {world}")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def make_host_mesh(device="cuda"):
    """Every process of the group as a 1-D ``("data",)`` mesh. Without an
    initialised group, a one-process group (NCCL on ``cuda``, gloo on
    ``cpu``); without CUDA it raises unless ``device="cpu"``."""
    _ensure_group(device)
    return make_mesh((dist.get_world_size(),), ("data",), device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: (16, 16) = ("data", "model"), 256 processes. Multi-pod:
    (2, 16, 16) = ("pod", "data", "model"), 512. The process group must
    already hold that many; otherwise this raises, as ``jax.make_mesh``
    does with too few devices."""
    shape, names = PRODUCTION_MESHES[multi_pod]
    if not dist.is_initialized():
        raise ValueError(f"the production mesh {shape} {names} needs an "
                         f"initialised process group of {math.prod(shape)} "
                         f"processes; none is initialised")
    return make_mesh(shape, names, device)
