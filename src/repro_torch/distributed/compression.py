"""Gradient compression: int8-quantized all-reduce with error feedback.

The port of the reference's ``distributed/compression.py``: the
symmetric int8 quantization VTA uses for weights (§5) applied to the DP
gradient all-reduce.  A scale shared by all ranks (the max-abs of every
rank's g + err, one scalar all-reduce), an int8 payload summed as int32
(VTA's wide accumulator), local error feedback (the residual carried to
the next step).

The payload crosses the wire as integers: ``torch.distributed.all_reduce``
of the int32 tensor over the data axes' process group, never a float
all-reduce rounded afterwards.  Each rank calls
:func:`compressed_mean_local` with its own gradient; on a ``DeviceMesh``
:func:`compressed_mean` is the reference's stacked entry point.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


def quantize_shard(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, float32 scale) of g by its own max-abs."""
    amax = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
    scale = (amax / 127.0).to(torch.float32)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -128, 127
                    ).to(torch.int8)
    return q, scale


def compressed_mean_local(g: torch.Tensor, err: torch.Tensor,
                          group: Optional[Any] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of the compressed mean over `group` (the data
    axes' process group; None: the default group): agree on a global
    scale (all-reduce MAX of the local max-abs), int8-quantize (g + err),
    all-reduce the int8 payload as int32, decode exactly.  Returns (the
    mean gradient, the same on every rank; this rank's new error)."""
    n = dist.get_world_size(group)
    gi = g.to(torch.float32) + err
    amax = torch.max(torch.abs(gi))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gi / scale), -128, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    mean = total.to(torch.float32) * scale / n
    new_err = gi - q.to(torch.float32) * scale        # local residual
    return mean.to(g.dtype), new_err


def compressed_mean(stacked_grads: torch.Tensor, errors: torch.Tensor,
                    mesh, axis: str = "data"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference entry point on a DeviceMesh: `stacked_grads` (n_shards,
    ...) holds each DP shard's gradient (every rank passes the whole
    stack and reduces its own row); returns (mean (...), new errors
    (n_shards, ...)), the errors gathered from every rank."""
    group = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    mean, err = compressed_mean_local(stacked_grads[r], errors[r], group)
    rows = [torch.empty_like(err) for _ in range(errors.shape[0])]
    dist.all_gather(rows, err.contiguous(), group=group)
    return mean, torch.stack(rows)
