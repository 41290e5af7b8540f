"""Mesh construction.

The port of the reference's ``launch/mesh.py`` over
``torch.distributed.device_mesh.init_device_mesh``.  The process group
must exist before a mesh is made: the caller makes it (``torchrun``, or
``torch.distributed.init_process_group`` with an address, a world size
and a rank), with ``nccl`` for the card and ``gloo`` where the caller
asks for the CPU.  A mesh's size must equal the world size.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist

from repro_torch.core.driver import TorchDeviceLike, resolve_torch_device


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: TorchDeviceLike = None):
    """A DeviceMesh of `shape` with axis names `axes` over every rank of
    the default process group, on `device`'s type (default the card).
    Raises RuntimeError without a process group and ValueError where the
    mesh's size differs from the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one first "
                           "(torchrun, or torch.distributed."
                           "init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} has {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    dev = resolve_torch_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: TorchDeviceLike = None):
    """The reference's production meshes: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def data_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
