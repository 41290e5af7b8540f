"""Public op: batched GQA decode step over a (possibly padded) KV cache.

A CPU tensor takes the plain version (``ref.decode_attention_ref_4d``); a
CUDA tensor launches the CUDA kernel; a ``meta`` tensor (the dry run)
takes the card's route with nothing launched (``kernels/_meta.py``: the
card's allocations, 4 S D FLOPs a query head over the whole cache, as
the reference's oracle computes it); any other device raises.  There is
no fallback between the two.
"""
from __future__ import annotations

import torch

from .. import _meta
from .._grad import refuse_grad
from .kernel import decode_attention_cuda
from .ref import KvLen, decode_attention_ref_4d


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: KvLen) -> torch.Tensor:
    """q: (B, 1, HQ, D); caches: (B, S, KH, D), HQ any multiple of KH;
    kv_len: an int or a one-element int32 tensor (on the card, read
    there).  q may be of another float dtype than the caches (a bfloat16
    model over float32 caches): the math is float32 on both.  Returns
    (B, 1, HQ, D) in q's dtype."""
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[3] \
            or q.shape[2] % k_cache.shape[2]:
        raise ValueError(f"decode_attention shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    refuse_grad("decode_attention", (q, k_cache, v_cache))
    dev = q.device
    if k_cache.device != dev or v_cache.device != dev:
        raise ValueError("decode_attention operands on different devices")
    if dev.type == "cpu":
        return decode_attention_ref_4d(q, k_cache, v_cache, kv_len)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention has no kernel for device {dev}")
    B, _, HQ, D = q.shape
    KH = k_cache.shape[2]
    qh = q.reshape(B * KH, HQ // KH, D).contiguous()
    out = decode_attention_cuda(qh, k_cache, v_cache, kv_len)
    if dev.type == "meta":
        _meta.record("decode_attention", 4 * B * HQ * k_cache.shape[1] * D,
                     q, k_cache, v_cache, out)
        return out.reshape(B, 1, HQ, D)
    decode_attention.launches += 1
    key = (B, k_cache.shape[1], HQ, KH, D, str(q.dtype).split(".")[-1],
           str(k_cache.dtype).split(".")[-1])
    decode_attention.shapes[key] = decode_attention.shapes.get(key, 0) + 1
    return out.reshape(B, 1, HQ, D)


#: kernel launches made by this op (plain-version calls do not count)
decode_attention.launches = 0
#: (B, S, HQ, KH, D, q dtype, cache dtype) -> launches at that shape
decode_attention.shapes = {}
