"""Ambient mesh context shared between the launch layer and model code.

The port of the reference's ``distributed/meshctx.py``.  The launch
layer sets the mesh once (a ``torch.distributed`` ``DeviceMesh``); code
that needs its axis sizes or a sharding constraint reads it here.  With
no mesh set, every hook is a no-op.

The port's model code holds plain tensors: the trainer's mesh path
gathers each parameter whole before the model sees it, so ``constrain``
is the identity on a plain tensor and redistributes only a ``DTensor``.
The reference's ``shard_map`` serves only the moe layer's expert
parallelism, which is not ported (ROADMAP Queue 1 item 6b).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

_MESH: Optional[Any] = None

#: a DeviceMesh, or a plain {axis name: size} mapping (the sharding rules
#: read only the axis sizes)
MeshLike = Any


def set_mesh(mesh: Optional[Any]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Any]:
    return _MESH


@contextmanager
def use_mesh(mesh: Any):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no axis names: make it with "
                         "launch.mesh.make_mesh(shape, axes)")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def _axis_size(mesh: MeshLike, entry) -> int:
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    names = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in names:
        n *= sizes[a]
    return n


def placements_of(spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of `spec` (one entry per tensor dim) on `mesh`:
    Shard(d) on each mesh axis named at dimension d, Replicate() on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec) if e is not None and axis
                    in (e if isinstance(e, tuple) else (e,))), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """A plain tensor, or no mesh set: x itself.  A DTensor: redistributed
    to `spec` on the ambient mesh, with the reference's fallbacks: axis
    names absent from the mesh are dropped (e.g. "pod" on the single-pod
    mesh), and of a tuple of axes the largest prefix that divides the
    dim is kept (none: that dim replicates)."""
    from torch.distributed.tensor import DTensor
    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(mesh)
    fixed = []
    used = set()
    for i, entry in enumerate(spec):
        if entry is None or i >= x.ndim:
            fixed.append(None)
            continue
        names = tuple(a for a in
                      (entry if isinstance(entry, tuple) else (entry,))
                      if a in sizes and a not in used)
        chosen = None
        while names:
            entry2 = names if len(names) > 1 else names[0]
            if x.shape[i] % _axis_size(sizes, entry2) == 0:
                chosen = entry2
                break
            names = names[:-1]
        fixed.append(chosen)
        if chosen is not None:
            used.update(names)
    return x.redistribute(mesh, placements_of(tuple(fixed), mesh))
