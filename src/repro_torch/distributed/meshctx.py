"""Ambient mesh context shared between the launch layer and model code,
and the collectives the model code runs over its axes.

The port of the reference's ``distributed/meshctx.py``.  The launch
layer sets the mesh (a ``torch.distributed`` ``DeviceMesh``); code that
needs its axis sizes, a sharding constraint or a collective reads it
here.  With no mesh set, every hook is a no-op.

The port's model code holds plain tensors.  Where the reference lets
GSPMD insert the collectives under ``param_specs`` and writes the moe
layer's expert parallelism with ``shard_map``, the port's layers call
the autograd-aware collectives below around the hand-written kernels:

* over the "model" axis (tensor and expert parallelism), where every
  model rank computes one objective and an activation replicated over
  the axis carries the same whole cotangent on each rank:
  ``copy_to_model`` (identity forward, all-reduce backward),
  ``reduce_from_model`` (all-reduce forward, identity backward; not
  ``torch.distributed.nn.functional.all_reduce``, whose backward
  all-reduces an already replicated cotangent again, ``tp`` times too
  large);
* over the data axes, where each rank's objective is its own rows' loss
  and the trainer sums the gradients over the ranks: ``all_reduce_data``
  and ``gather_data``, whose backwards sum the ranks' cotangents
  (all-reduce, reduce-scatter);
* ``max_over`` (an all-reduce MAX, no gradient): the int8 serving path's
  per-tensor activation scale, the max over the global activation as
  the reference's ``quantized_linear`` takes it under GSPMD
  (``models/layers.py:linear_apply``).

With no mesh, an axis of size 1, or a "model" axis that the config
lists among its data axes (the recurrent archs' ``dp_over_model``), a
helper is the identity, so the one-device and data-parallel paths stay
bitwise as they were.  The collectives are ``torch.distributed``'s own
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``)
on plain tensors, over ``nccl`` or ``gloo``: ``gloo`` takes each of them
on CUDA tensors in float32, bfloat16, float16, int32 and int64 (checked
on the H100 machine, PyTorch 2.11), so two ranks can share one card.
DTensor's functional collectives (``full_tensor``, ``redistribute``)
are not used on the mesh path: over ``gloo`` on CUDA tensors they crash
the process there (SIGSEGV in ``wait_tensor``).
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_MESH: Optional[Any] = None
#: the mesh axes that split the batch of the step being run (None: every
#: data axis of the config that the mesh has)
_BATCH_AXES: Optional[Tuple[str, ...]] = None

#: a DeviceMesh, or a plain {axis name: size} mapping (the sharding rules
#: read only the axis sizes)
MeshLike = Any


def set_mesh(mesh: Optional[Any]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Any]:
    return _MESH


@contextmanager
def use_mesh(mesh: Any, batch_axes: Optional[Sequence[str]] = None):
    """`mesh` as the ambient mesh inside the block; `batch_axes` the axes
    that split its batch (the trainer's step sets them from
    ``batch_specs``)."""
    global _MESH, _BATCH_AXES
    prev = _MESH, _BATCH_AXES
    _MESH = mesh
    _BATCH_AXES = None if batch_axes is None else tuple(batch_axes)
    try:
        yield mesh
    finally:
        _MESH, _BATCH_AXES = prev


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


# ----------------------------------------------------------------------
# the axes of the ambient mesh, and the collectives over them
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Axis:
    """One axis of the ambient mesh as this process sees it: its process
    group, size and this process's index along it."""
    name: str
    group: Any
    size: int
    rank: int


def axis_of(mesh, name: str) -> Axis:
    """The axis `name` of the DeviceMesh `mesh`, for this process."""
    dim = mesh.mesh_dim_names.index(name)
    group = mesh.get_group(dim)
    return Axis(name, group, int(mesh.size(dim)),
                int(mesh.get_coordinate()[dim]))


def model_axis(cfg) -> Optional[Axis]:
    """The ambient mesh's "model" axis (``cfg.sharding.model_axis``) where
    the layers compute sharded over it: the mesh has it with a size above
    1 and the config does not list it among its data axes.  Else None."""
    mesh = _MESH
    sc = cfg.sharding
    if mesh is None or sc.model_axis is None or isinstance(mesh, Mapping) \
            or sc.model_axis not in (mesh.mesh_dim_names or ()) \
            or sc.model_axis in sc.data_axes:
        return None
    ax = axis_of(mesh, sc.model_axis)
    return ax if ax.size > 1 else None


def data_axes(cfg) -> Tuple[Axis, ...]:
    """The ambient mesh's axes that split the batch (major to minor):
    those the step named (``use_mesh(batch_axes=)``), else the config's
    data axes that the mesh has; never the "model" axis where it computes
    sharded.  Sizes of 1 included (the moe layer's branches read their
    names)."""
    mesh = _MESH
    if mesh is None or isinstance(mesh, Mapping):
        return ()
    sc = cfg.sharding
    names = _BATCH_AXES if _BATCH_AXES is not None else tuple(
        a for a in sc.data_axes if a in (mesh.mesh_dim_names or ()))
    tp = model_axis(cfg)
    return tuple(axis_of(mesh, a) for a in names
                 if tp is None or a != tp.name)


def all_reduce_sum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over `ax` of a copy of x."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ax.group)
    return out


def max_over(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """The elementwise max of x over every rank of `axes` (serving only:
    no gradient).  The all-reduce runs in float32, where every float32 and
    bfloat16 value is exact, so the result in x's dtype is the max of the
    ranks' values."""
    out = x.to(torch.float32).contiguous().clone()
    for ax in axes:
        if ax.size > 1:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group)
    return out.to(x.dtype)


def all_gather_blocks(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The ranks' x concatenated along `dim`, in rank order."""
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] * ax.size,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=ax.group)
    return out.movedim(0, dim)


def reduce_scatter_blocks(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum over `ax` of x."""
    x = x.movedim(dim, 0).contiguous()
    if x.shape[0] % ax.size:
        raise ValueError(f"a reduce-scatter of {x.shape[0]} rows over "
                         f"{ax.size} ranks")
    out = torch.empty((x.shape[0] // ax.size,) + x.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=ax.group)
    return out.movedim(0, dim).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.ax), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, sum_grad):
        ctx.ax, ctx.sum_grad = ax, sum_grad
        return all_reduce_sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_sum(g, ctx.ax) if ctx.sum_grad else g), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather_blocks(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_blocks(g, ctx.ax, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """x, replicated over the model axis, entering compute that is split
    over it: identity forward; the backward sums the ranks' partial
    cotangents (all-reduce)."""
    return x if ax is None else _Copy.apply(x, ax)


def reduce_from_model(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum over the model axis of each rank's partial x (all-reduce),
    leaving replicated; the backward is the identity (the replicated
    cotangent is each partial's whole cotangent)."""
    return x if ax is None else _AllReduce.apply(x, ax, False)


def all_reduce_data(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """The sum of x over the data `axes` (each rank's objective reads
    it): all-reduce forward and backward."""
    for ax in axes:
        if ax.size > 1:
            x = _AllReduce.apply(x, ax, True)
    return x


def gather_data(x: torch.Tensor, axes: Sequence[Axis],
                dim: int = 0) -> torch.Tensor:
    """The rows of every rank along the data `axes` (major to minor, as
    the batch was split), concatenated along `dim`: all-gather forward,
    reduce-scatter backward (the ranks' cotangents of a row summed on the
    rank that owns it)."""
    for ax in reversed(tuple(axes)):
        if ax.size > 1:
            x = _Gather.apply(x, ax, dim)
    return x


def data_block(x: torch.Tensor, axes: Sequence[Axis],
               dim: int = 0) -> torch.Tensor:
    """This rank's rows of x (the whole batch's) along the data `axes`,
    major to minor, as ``gather_data`` concatenated them."""
    for ax in axes:
        if ax.size > 1:
            n = x.shape[dim] // ax.size
            x = x.narrow(dim, ax.rank * n, n)
    return x
