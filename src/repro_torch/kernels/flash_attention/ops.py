"""Public op: (B, S, H, D)-layout GQA attention.

A CPU tensor takes the plain version (:func:`flash_attention_plain`: the
materialized oracle up to ``_CHUNKED_THRESHOLD`` score elements per head,
the chunked one above, as the reference op chooses); a CUDA tensor
launches a CUDA kernel, chosen by dtype (``kernel.route``: bfloat16 the
wgmma kernel, float32 the 3xTF32 one); a ``meta`` tensor (the dry run)
takes the card's route with nothing launched (``kernels/_meta.py``: the
card's allocations, the work reported as the reference's oracle does it,
4 S Sk D FLOPs a head forward and 8 backward, masked or not); any other
device raises.  There is no fallback between any of them.

Operands of mixed dtype (whisper's decode step: a bfloat16 query over K/V
read from float32 caches) follow one fixed rule, the reference's
promotion: on the CPU the plain version computes in float32 anyway; on
the card the bfloat16 operands are upcast to float32, which is exact, the
3xTF32 kernel runs, and the result is cast to q's dtype.  K/V are never
cast down.

The op carries a gradient: when grad mode is on and an operand requires
grad, it runs inside a ``torch.autograd.Function`` whose forward is the
dispatch above, asked also for each query row's log-sum-exp L
(:func:`flash_attention_fwd`: the kernels write it beside the output,
the plain version takes it from ``ref.attention_lse_ref``), and whose
backward (:func:`flash_attention_bwd`) takes L and dispatches by device
in the same way: a CPU tensor takes the plain backward
(``ref.attention_bwd_ref``), a CUDA tensor the backward kernel
(``csrc/flash_bwd.cu``, one dtype, float32 or bfloat16, every D the
forward takes; anything else raises ValueError before any launch), any
other device raises.  The Function saves q, k, v, the output and L.
Otherwise (serving) the Function is not entered, nothing is saved and no
L is written.  Backward launches are counted apart from the forward's.

Every head dim D from 1 runs on the card's tensor cores
(``kernel.head_dim_plan``): q, k and v are zero-padded here to a multiple
of 16 (bfloat16) or 4 (float32) where D is not one, the scale kept at
1/sqrt(D) and the output and gradients sliced back (exact: zero columns
add nothing to q k^T, and the padded columns of the output and of dq, dk,
dv are zero); up to 128 the kernels above, above 128 the wide kernels
(``csrc/flash_wide.cu``: the head dim in chunks, the output written in
slices, ``kernel.wide_fwd_launches``), forward and backward.  D below 1
raises ValueError.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.trace import FLASH_ATTENTION, span

from .. import _meta
from .kernel import (flash_attention_bwd_cuda, flash_attention_cuda,
                     flash_wide_bwd_cuda, flash_wide_cuda, head_dim_plan)
from .ref import (attention_bwd_ref, attention_lse_ref, attention_ref,
                  attention_ref_chunked)

# above this many score elements per head the materialized oracle would
# dominate memory: the plain version switches to the chunked loop
_CHUNKED_THRESHOLD = 2048 * 2048


def _to_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D)"""
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D)


def _from_heads(x: torch.Tensor, B: int) -> torch.Tensor:
    BH, S, D = x.shape
    return x.reshape(B, BH // B, S, D).transpose(1, 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention operands on different devices")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The plain version of :func:`flash_attention`, on any device."""
    _check(q, k, v)
    B, S, HQ, _ = q.shape
    group = HQ // k.shape[2]
    if S * k.shape[1] > _CHUNKED_THRESHOLD:
        return attention_ref_chunked(q, k, v, group=group, causal=causal)
    out = attention_ref(_to_heads(q), _to_heads(k), _to_heads(v),
                        group=group, causal=causal)
    return _from_heads(out, B)


def _pad(t: torch.Tensor, dp: int) -> torch.Tensor:
    """t with its last dim zero-padded to dp (t itself where it is dp)."""
    return t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))


def _cuda_forward(q, k, v, causal, with_lse):
    """The kernel of q's head dim (``kernel.head_dim_plan``), on operands
    of one dtype, padded and sliced back as the plan says."""
    D = q.shape[-1]
    plan = head_dim_plan(D, q.dtype)
    fwd = flash_wide_cuda if plan.kernels == "wide" else flash_attention_cuda
    if plan.dp == D:
        return fwd(q, k, v, causal, with_lse)
    out = fwd(*(_pad(t, plan.dp) for t in (q, k, v)), causal, with_lse,
              scale=1.0 / math.sqrt(D))
    if with_lse:
        return out[0][..., :D].contiguous(), out[1]
    return out[..., :D].contiguous()


def _cuda_backward(q, k, v, o, do, lse, causal):
    """The backward kernels of q's head dim, padded and sliced back as
    ``kernel.head_dim_plan`` says."""
    D = q.shape[-1]
    plan = head_dim_plan(D, q.dtype)
    bwd = flash_wide_bwd_cuda if plan.kernels == "wide" \
        else flash_attention_bwd_cuda
    if plan.dp == D:
        return bwd(q, k, v, o, do, lse, causal)
    grads = bwd(*(_pad(t, plan.dp) for t in (q, k, v, o, do)), lse, causal,
                scale=1.0 / math.sqrt(D))
    return tuple(g[..., :D].contiguous() for g in grads)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, with_lse: bool = False):
    """The output, or (output, L (B, HQ, S) float32) with `with_lse`."""
    dev = q.device
    if dev.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal)
        if not with_lse:
            return out
        return out, attention_lse_ref(q, k, group=q.shape[2] // k.shape[2],
                                      causal=causal)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention has no kernel for device {dev}")
    names = [str(t.dtype).split(".")[-1] for t in (q, k, v)]
    if len(set(names)) == 1:
        out = _cuda_forward(q, k, v, causal, with_lse)
        dtype = names[0]
    else:
        # the reference's promotion: bfloat16 is exact in float32
        up = [t.float() if t.dtype == torch.bfloat16 else t
              for t in (q, k, v)]
        out = _cuda_forward(*up, causal, with_lse)
        out = (out[0].to(q.dtype), out[1]) if with_lse else out.to(q.dtype)
        dtype = f"{names[0]}/{names[1]}"
    if dev.type == "meta":
        B, S, HQ, D = q.shape
        _meta.record("flash_attention", 4 * B * HQ * S * k.shape[1] * D,
                     q, k, v, *(out if with_lse else (out,)))
        return out
    if q.numel():                   # an empty output launches nothing
        flash_attention.launches += 1
        B, S, HQ, D = q.shape
        key = (B, S, k.shape[1], HQ, k.shape[2], D, bool(causal), dtype)
        flash_attention.shapes[key] = flash_attention.shapes.get(key, 0) + 1
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True):
    """(out, L): :func:`flash_attention`'s output and each query row's
    log-sum-exp L of its scaled scores, (B, HQ, S) float32, +inf for a row
    that sees no key; what the backward takes.  On the card the forward
    kernel writes L beside the output (one launch, counted as the op's),
    and the output is bitwise the one it writes without L."""
    _check(q, k, v)
    return _forward(q, k, v, causal, True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True,
                        lse: Optional[torch.Tensor] = None):
    """The gradient (dq, dk, dv) of ``o = flash_attention(q, k, v)`` for
    the output gradient do, in the dtypes of q, k and v, from the
    forward's L (``lse``, as :func:`flash_attention_fwd` returns it).  A
    CPU tensor takes the plain backward (which recomputes L where none is
    given), a CUDA tensor the backward kernel (counted in
    ``flash_attention.bwd_launches`` and ``.bwd_shapes``; it needs L),
    any other device raises ValueError."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape \
            or o.device != q.device or do.device != q.device:
        raise ValueError(f"flash_attention backward: out {tuple(o.shape)} "
                         f"and grad {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)} on its device")
    B, S, HQ, D = q.shape
    if lse is not None and (lse.shape != (B, HQ, S) or lse.device != q.device
                            or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention backward: lse {tuple(lse.shape)} "
                         f"{lse.dtype} must be ({B}, {HQ}, {S}) float32 on "
                         f"q's device")
    dev = q.device
    if dev.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, group=HQ // k.shape[2],
                                 causal=causal, lse=lse)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention has no backward kernel for "
                         f"device {dev}")
    if lse is None:
        raise ValueError("the flash_attention backward kernel takes the "
                         "forward's log-sum-exp (lse, from "
                         "flash_attention_fwd)")
    grads = _cuda_backward(q, k, v, o, do, lse, causal)
    if dev.type == "meta":
        _meta.record("flash_attention_bwd", 8 * B * HQ * S * k.shape[1] * D,
                     q, k, v, o, do, lse, *grads)
        return grads
    if min(B, S, k.shape[1], HQ):   # an empty operand launches nothing
        flash_attention.bwd_launches += 1
        key = (B, S, k.shape[1], HQ, k.shape[2], D, bool(causal),
               str(q.dtype).split(".")[-1])
        flash_attention.bwd_shapes[key] = \
            flash_attention.bwd_shapes.get(key, 0) + 1
    return grads


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its gradient: the forward is the op's dispatch
    with L written, the backward :func:`flash_attention_bwd` from it."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with span(FLASH_ATTENTION):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, do,
                                             causal=ctx.causal, lse=lse)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, HQ, D); k/v: (B, Sk, KH, D), HQ a multiple of KH.
    Returns (B, S, HQ, D) in q's dtype; q and k/v may differ in dtype
    (see the module docstring).  Query head h reads kv head
    h // (HQ // KH); with ``causal`` the diagonal is aligned bottom-right
    (row i sees keys j <= i + Sk - S).  Differentiable when grad mode is
    on and an operand requires grad."""
    _check(q, k, v)
    with span(FLASH_ATTENTION):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, causal)
        return _forward(q, k, v, causal)


#: kernel launches made by this op (plain-version calls do not count)
flash_attention.launches = 0
#: (B, S, Sk, HQ, KH, D, causal, dtype) -> launches at that shape; dtype
#: "bfloat16", "float32", or "<q dtype>/<k/v dtype>" where they differ
flash_attention.shapes = {}
#: backward kernel calls (each launches flash_bwd.cu's three kernels:
#: Delta, dk dv, dq), and
#: the shapes they ran at, keyed as ``shapes`` is
flash_attention.bwd_launches = 0
flash_attention.bwd_shapes = {}
