"""Optimizers over trees of tensors (no external deps).

The port of the reference's ``optim/optimizers.py``: AdamW for everything
that fits, Adafactor (factored second moment, no first moment) for the
1T-param kimi-k2 config.  The same float32 arithmetic and casts as the
reference, op for op, except that the port updates in place where the
reference returns new trees: parameters, gradients (clipping) and state
are overwritten, and the trees passed in are returned, so call sites read
as the reference's.  AdamW and the scaling of clipping take a large leaf
a slice of its leading dim at a time (at most ``CHUNK`` elements), which
bounds their float32 temporaries (the stacked MLP leaf of llama3.2-3b is
705 M elements) and changes no result: their arithmetic is elementwise.
Reductions take each leaf whole, since slicing one would change the
order of its float32 sum: the global norm (one float32 copy of a leaf at
a time, squared in place) and Adafactor's update clipping.  Trees are walked in sorted key
order (``tree.py``), so the global norm sums leaves in the reference's
order.

On the trainer's mesh path each process updates its shard of a leaf.
AdamW is elementwise and needs nothing more.  Adafactor's factored row
and column means, the normalising mean of ``vr`` and the update-RMS clip
reduce over the whole leaf: ``adafactor_update(..., sharded=)`` names,
for each leaf, the mesh axes its shard is split over along each
dimension, and each of those reductions is a local sum all-reduced over
them and divided by the whole leaf's count, so every shard takes the
whole leaf's values (the reference gets them from GSPMD).
"""
from __future__ import annotations

import math

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import flatten, map_tree

Params = Any

#: the most elements of a leaf that AdamW and clipping's scaling take at
#: once
CHUNK = 1 << 25


def _slices(t: torch.Tensor) -> List[torch.Tensor]:
    """t as views of at most CHUNK elements along its leading dim (t itself
    when it is small or 0-d)."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        return [t]
    rows = max(1, CHUNK // (t.numel() // t.shape[0]))
    return list(torch.split(t, rows, dim=0))


# ----------------------------------------------------------------------
# grad clipping
# ----------------------------------------------------------------------
@torch.no_grad()
def global_norm(tree: Params,
                reduce_sq: Optional[Callable[[Dict[str, torch.Tensor]],
                                             Dict[str, torch.Tensor]]] = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in float32, each leaf
    reduced whole, the leaves summed in order.  `reduce_sq` maps {path:
    the leaf's sum of squares} to the whole leaf's where each process
    holds a shard of it (the trainer's mesh path)."""
    sq = {k: torch.sum(g.to(torch.float32, copy=True).square_())
          for k, g in flatten(tree).items()}
    if reduce_sq is not None:
        sq = reduce_sq(sq)
    total = None
    for s in sq.values():
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float,
                        reduce_sq: Optional[Callable] = None
                        ) -> Tuple[Params, torch.Tensor]:
    """grads scaled by min(1, max_norm / max(norm, 1e-9)) in float32 and
    cast back, in place; returns (grads, norm).  `reduce_sq` as in
    :func:`global_norm`."""
    norm = global_norm(grads, reduce_sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in flatten(grads).values():
        for s in _slices(g):
            s.copy_((s.to(torch.float32) * scale).to(s.dtype))
    return grads, norm


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
def adamw_init(params: Params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "count": torch.zeros((), dtype=torch.int32)}


def _bias_correction(b: float, c: torch.Tensor) -> float:
    """1 - b^c in float32, as a Python float holding the float32 value."""
    return float(1.0 - torch.tensor(b, dtype=torch.float32) ** c)


@torch.no_grad()
def adamw_update(grads: Params, state: Dict[str, Any], params: Params, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Params, Dict[str, Any]]:
    """One AdamW step, in place on params, m and v; lr a float or a 0-d
    float32 tensor."""
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1, bc2 = _bias_correction(b1, c), _bias_correction(b2, c)
    lr = float(lr)
    flat_p = flatten(params)
    flat_g, flat_m, flat_v = (flatten(t) for t in (grads, state["m"],
                                                   state["v"]))
    for name, p in flat_p.items():
        for g, m, v, ps in zip(*(_slices(t) for t in (
                flat_g[name], flat_m[name], flat_v[name], p))):
            g = g.to(torch.float32)
            mn = b1 * m + (1 - b1) * g
            vn = b2 * v + (1 - b2) * g * g
            step = (mn / bc1) / (torch.sqrt(vn / bc2) + eps)
            step = step + weight_decay * ps.to(torch.float32)
            m.copy_(mn)
            v.copy_(vn)
            ps.copy_((ps.to(torch.float32) - lr * step).to(ps.dtype))
    return params, {"m": state["m"], "v": state["v"], "count": count}


# ----------------------------------------------------------------------
# Adafactor (factored second moment; memory ~ O(rows + cols))
# ----------------------------------------------------------------------
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Params) -> Dict[str, Any]:
    def init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    return {"v": map_tree(init, params),
            "count": torch.zeros((), dtype=torch.int32)}


#: per leaf path, {tensor dim: the mesh axes (``meshctx.Axis``) the local
#: shard is split over along it}
ShardAxes = Mapping[str, Mapping[int, Sequence[Any]]]


def _mean(x: torch.Tensor, dims: Tuple[int, ...],
          axes: Sequence[Any], keepdim: bool = False) -> torch.Tensor:
    """The mean of x over `dims` (all of them where empty), x a shard
    split over `axes` along them: torch.mean where no axis splits it,
    else the local sum all-reduced over the axes and divided by the
    whole count."""
    axes = [a for a in axes if a.size > 1]
    if not axes:
        return torch.mean(x, dim=dims, keepdim=keepdim) if dims \
            else torch.mean(x)
    n = x.numel() if not dims else math.prod(x.shape[d] for d in dims)
    out = torch.sum(x, dim=dims, keepdim=keepdim) if dims else torch.sum(x)
    for a in axes:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=a.group)
        n *= a.size
    return out / n


@torch.no_grad()
def adafactor_update(grads: Params, state: Dict[str, Any], params: Params,
                     *, lr, decay: float = 0.99, eps: float = 1e-30,
                     clip_threshold: float = 1.0, weight_decay: float = 0.0,
                     sharded: Optional[ShardAxes] = None
                     ) -> Tuple[Params, Dict[str, Any]]:
    """One Adafactor step, in place on params and the second moments.
    `sharded` (the trainer's mesh path): {leaf path: {dim: axes}} for the
    leaves whose local shard is split over mesh axes."""
    count = state["count"] + 1
    lr = float(lr)

    def upd(g, v, p, split):
        nd = g.dim()

        def axes_of(*dims):
            return [a for d in dims for a in split.get(d % nd, ())]
        g = g.to(torch.float32)
        g2 = g * g + eps
        if _factored(g.shape):
            vr = decay * v["vr"] + (1 - decay) * _mean(g2, (-1,),
                                                       axes_of(-1))
            vc = decay * v["vc"] + (1 - decay) * _mean(g2, (-2,),
                                                       axes_of(-2))
            denom = (vr[..., None] / _mean(vr, (-1,), axes_of(-2),
                                           keepdim=True)[..., None]
                     ) * vc[..., None, :]
            update = g * torch.rsqrt(denom + eps)
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            nv = decay * v["v"] + (1 - decay) * g2
            update = g * torch.rsqrt(nv + eps)
            v["v"].copy_(nv)
        # update clipping (RMS)
        rms = torch.sqrt(_mean(torch.square(update), (),
                               axes_of(*range(nd))) + eps)
        update = update / torch.clamp(rms / clip_threshold, min=1.0)
        if weight_decay:
            update = update + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * update).to(p.dtype))

    # at each parameter leaf, the state holds its {"vr", "vc"} or {"v"}
    flat_g = flatten(grads)
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, t in flatten(state["v"]).items():
        path, name = k.rsplit("/", 1)
        moments.setdefault(path, {})[name] = t
    for path, p in flatten(params).items():
        upd(flat_g[path], moments[path], p, (sharded or {}).get(path, {}))
    return params, {"v": state["v"], "count": count}


# ----------------------------------------------------------------------
# factory
# ----------------------------------------------------------------------
def make_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
