"""Public op: the chunked GLA scan over (B, S, H, ...) tensors.

A CPU tensor takes the plain version (:func:`gla_chunk_plain`, over
``ref.gla_chunk_ref``); a CUDA tensor launches the CUDA kernel; a
``meta`` tensor (the dry run) takes the card's route with nothing
launched (``kernels/_meta.py``: the card's allocations, the work reported
as the reference's ``chunked_gla`` does it, its four chunk products
forward and twice that backward); any other device raises.  There is no
fallback between the two.  Both keep the
reference op's rule on the chunk: Q = min(chunk, S) must divide S.

q and k have H heads, or one (head dim 1) read for every head of v: the
op broadcasts them over the heads (stride 0, read in place by the kernel),
as Mamba2 broadcasts its C and B.

The op carries a gradient: when grad mode is on and an operand requires
grad, it runs inside a ``torch.autograd.Function`` whose forward is the
dispatch above and whose backward (:func:`gla_chunk_bwd`) dispatches by
device in the same way: a CPU tensor takes the plain backward
(:func:`gla_chunk_bwd_plain`, over ``ref.gla_chunk_bwd_ref``), a CUDA
tensor the backward kernel (``csrc/gla_bwd.cu``), any other device
raises.  The gradient of a one-head q or k is summed over the heads (by
the kernel on the card), so autograd has nothing left to sum.  Otherwise
(serving) the Function is not entered and nothing is saved.  Backward
launches are counted apart from the forward's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.trace import GLA_CHUNK, span

from .. import _meta
from .kernel import MAX_TILE, gla_chunk_bwd_cuda, gla_chunk_cuda
from .ref import gla_chunk_bwd_ref, gla_chunk_ref


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           la: torch.Tensor, h0: Optional[torch.Tensor], chunk: int) -> int:
    """The chunk length Q; raises on shapes or devices that do not fit."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:2] != q.shape[:2] \
            or q.shape[2] not in (1, v.shape[2]) \
            or la.shape != v.shape[:3] \
            or (h0 is not None and h0.shape != (q.shape[0], v.shape[2],
                                                q.shape[3], v.shape[3])):
        raise ValueError(f"gla_chunk shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, la "
                         f"{tuple(la.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if any(t is not None and t.device != q.device for t in (k, v, la, h0)):
        raise ValueError("gla_chunk operands on different devices")
    S = q.shape[1]
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"gla_chunk: S = {S} is not a multiple of the "
                         f"chunk min({chunk}, S) = {Q}")
    return Q


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """q or k over H heads: a one-head operand as a stride-0 view."""
    if t.shape[2] == H:
        return t
    return t.expand(t.shape[0], t.shape[1], H, t.shape[3])


def _to_bh(x: torch.Tensor, nc: int, Q: int) -> torch.Tensor:
    """(B, S, H, ...) -> (B H, nc, Q, ...)"""
    B, S, H = x.shape[:3]
    return x.transpose(1, 2).reshape(B * H, nc, Q, *x.shape[3:])


def gla_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    la: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                    chunk: int = 64, y_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`gla_chunk`, on any device."""
    Q = _check(q, k, v, la, h0, chunk)
    B, S, H, P = v.shape
    N = q.shape[3]
    nc = S // Q
    q, k = _heads(q, H), _heads(k, H)
    h0b = (torch.zeros((B * H, N, P), dtype=torch.float32, device=q.device)
           if h0 is None else h0.reshape(B * H, N, P))
    yb, hb = gla_chunk_ref(_to_bh(q, nc, Q), _to_bh(k, nc, Q),
                           _to_bh(v, nc, Q), _to_bh(la, nc, Q), h0b,
                           y_dtype=y_dtype)
    y = yb.reshape(B, H, S, P).transpose(1, 2)
    return y, hb.reshape(B, H, N, P)


def _key(q: torch.Tensor, v: torch.Tensor, Q: int) -> tuple:
    """(B, S, H, N, P, Q, q dtype, heads broadcast): a shapes key."""
    B, S, H, P = v.shape
    return (B, S, H, q.shape[3], P, Q, str(q.dtype).split(".")[-1],
            H > 1 and (q.shape[2] == 1 or q.stride(2) == 0))


def _oracle_flops(q: torch.Tensor, v: torch.Tensor, Q: int) -> int:
    """The FLOPs of the reference's ``chunked_gla`` forward: per chunk of
    Q rows and head, q k^T (2 Q Q N), its masked scores times v (2 Q Q
    P), the chunk's state k^T v (2 Q N P) and q times the carried state
    (2 Q N P)."""
    B, S, H, P = v.shape
    N = q.shape[3]
    return B * H * (S // Q) * (2 * Q * Q * (N + P) + 4 * Q * N * P)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             la: torch.Tensor, h0: Optional[torch.Tensor], Q: int,
             chunk: int, y_dtype: Optional[torch.dtype]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = q.device
    if dev.type == "cpu":
        return gla_chunk_plain(q, k, v, la, h0, chunk=chunk, y_dtype=y_dtype)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"gla_chunk has no kernel for device {dev}")
    H = v.shape[2]
    out = gla_chunk_cuda(_heads(q, H), _heads(k, H), v, la, h0,
                         min(Q, MAX_TILE), y_dtype or q.dtype)
    if dev.type == "meta":
        _meta.record("gla_chunk", _oracle_flops(q, v, Q), q, k, v, la, h0,
                     *out)
        return out
    gla_chunk.launches += 1
    key = _key(q, v, Q)
    gla_chunk.shapes[key] = gla_chunk.shapes.get(key, 0) + 1
    return out


def gla_chunk_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        la: torch.Tensor, h0: Optional[torch.Tensor],
                        dy: torch.Tensor, dh: Optional[torch.Tensor], *,
                        chunk: int = 64, dtype: torch.dtype = torch.float32
                        ) -> Tuple[torch.Tensor, ...]:
    """The plain backward in the op's layout, on any device: (dq, dk, dv,
    dla, dh0) in `dtype`, each in its operand's shape (a one-head q's and
    k's gradient summed over the heads)."""
    Q = _check(q, k, v, la, h0, chunk)
    B, S, H, P = v.shape
    N = q.shape[3]
    nc = S // Q
    one_head = q.shape[2] != H
    q, k = _heads(q, H), _heads(k, H)
    h0b = None if h0 is None else h0.reshape(B * H, N, P)
    dhb = None if dh is None else dh.reshape(B * H, N, P)
    grads = gla_chunk_bwd_ref(
        _to_bh(q, nc, Q), _to_bh(k, nc, Q), _to_bh(v, nc, Q),
        _to_bh(la, nc, Q), h0b, _to_bh(dy, nc, Q), dhb, dtype=dtype)
    dq, dk, dv, dla, dh0 = grads
    dq, dk, dv = [g.reshape(B, H, S, -1).transpose(1, 2)
                  for g in (dq, dk, dv)]
    if one_head:
        dq, dk = dq.sum(2, keepdim=True), dk.sum(2, keepdim=True)
    return (dq, dk, dv, dla.reshape(B, H, S).transpose(1, 2),
            dh0.reshape(B, H, N, P))


def gla_chunk_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  la: torch.Tensor, h0: Optional[torch.Tensor],
                  dy: torch.Tensor, dh: Optional[torch.Tensor], *,
                  chunk: int = 64) -> Tuple[torch.Tensor, ...]:
    """The gradient (dq, dk, dv, dla, dh0) of ``gla_chunk(q, k, v, la, h0,
    chunk=chunk)`` for the output gradients dy (B, S, H, P) and dh (B, H,
    N, P) or None, each in its operand's dtype and shape (a one-head q or
    k: summed over the heads; dh0 float32, also where h0 is None).  A CPU
    tensor takes the plain backward, a CUDA tensor the backward kernel
    (counted in ``gla_chunk.bwd_launches`` and ``.bwd_shapes``), any
    other device raises ValueError."""
    Q = _check(q, k, v, la, h0, chunk)
    if dy.shape != v.shape or dy.device != q.device \
            or (dh is not None and (dh.shape != (v.shape[0], v.shape[2],
                                                 q.shape[3], v.shape[3])
                                    or dh.device != q.device)):
        raise ValueError(f"gla_chunk backward: dy {tuple(dy.shape)} must "
                         f"match v {tuple(v.shape)}, dh "
                         f"{None if dh is None else tuple(dh.shape)} the "
                         f"state, on q's device")
    dev = q.device
    if dev.type == "cpu":
        dq, dk, dv, dla, dh0 = gla_chunk_bwd_plain(q, k, v, la, h0, dy, dh,
                                                   chunk=chunk)
    elif dev.type in ("cuda", "meta"):
        f32 = [None if t is None else t.to(torch.float32)
               for t in (v, la, h0, dy, dh)]
        dq, dk, dv, dla, dh0 = gla_chunk_bwd_cuda(q, k, *f32[:3], *f32[3:])
    else:
        raise ValueError(f"gla_chunk has no backward kernel for device "
                         f"{dev}")
    if dev.type == "meta":
        _meta.record("gla_chunk_bwd", 2 * _oracle_flops(q, v, Q), q, k, v,
                     la, h0, dy, dh, dq, dk, dv, dla, dh0)
    elif dev.type == "cuda":
        gla_chunk.bwd_launches += 1
        key = _key(q, v, Q)
        gla_chunk.bwd_shapes[key] = gla_chunk.bwd_shapes.get(key, 0) + 1
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dla.to(la.dtype),
            dh0)


class _GlaChunk(torch.autograd.Function):
    """gla_chunk with its gradient: the forward is the op's dispatch, the
    backward :func:`gla_chunk_bwd`.  An output gradient autograd leaves
    out (the final state's, in training) counts as zeros."""

    @staticmethod
    def forward(ctx, q, k, v, la, h0, Q, chunk, y_dtype):
        y, h = _forward(q, k, v, la, h0, Q, chunk, y_dtype)
        ctx.save_for_backward(q, k, v, la, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        q, k, v, la, h0 = ctx.saved_tensors
        with span(GLA_CHUNK):
            if dy is None:
                dy = torch.zeros(v.shape, dtype=torch.float32,
                                 device=v.device)
            dq, dk, dv, dla, dh0 = gla_chunk_bwd(q, k, v, la, h0, dy, dh,
                                                 chunk=ctx.chunk)
        return dq, dk, dv, dla, (None if h0 is None else dh0), None, None, \
            None


def gla_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              la: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
              chunk: int = 64, y_dtype: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, S, H, N), or (B, S, 1, N) for every head; v: (B, S, H,
    P); la: (B, S, H) log-decay (<= 0); h0: (B, H, N, P) or None (zeros).
    Returns y (B, S, H, P) in `y_dtype` (default q's dtype, as
    ``gla_chunk_pallas`` returns it) and the final state h (B, H, N, P)
    float32.  On the card q and k are float32 or bfloat16 and may be
    broadcast over heads (stride 0, read in place); v, la and h0 are
    float32.  Differentiable when grad mode is on and an operand requires
    grad."""
    Q = _check(q, k, v, la, h0, chunk)
    with span(GLA_CHUNK):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, la, h0)):
            return _GlaChunk.apply(q, k, v, la, h0, Q, chunk, y_dtype)
        return _forward(q, k, v, la, h0, Q, chunk, y_dtype)


#: kernel launches made by this op (plain-version calls do not count)
gla_chunk.launches = 0
#: (B, S, H, N, P, Q, q dtype, heads broadcast) -> launches at that shape
gla_chunk.shapes = {}
#: backward kernel calls (each launches gla_bwd.cu's kernels), and the
#: shapes they ran at, keyed as ``shapes`` is
gla_chunk.bwd_launches = 0
gla_chunk.bwd_shapes = {}
