"""Plain PyTorch versions of single-step decode attention with length
masking (float32 math, output in q's dtype).  The CPU tests run them; on
the card the kernel is held against :func:`decode_attention_ref_4d`."""
from __future__ import annotations

from typing import Union

import torch

NEG_INF = -1e30

KvLen = Union[int, torch.Tensor]


def _len(kv_len: KvLen, device: torch.device) -> torch.Tensor:
    """kv_len as a 0-d int64 tensor on `device` (an int, or a tensor of
    one element)."""
    return torch.as_tensor(kv_len, device=device).reshape(()) \
        .to(torch.int64)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: KvLen) -> torch.Tensor:
    """q: (B*KH, G, D); k/v: (B*KH, S, D); kv_len: int or one-element
    int tensor."""
    D = q.shape[-1]
    S = k.shape[1]
    s = torch.einsum("hgd,hkd->hgk", q.to(torch.float32),
                     k.to(torch.float32)) / (D ** 0.5)
    valid = torch.arange(S, device=q.device)[None, None, :] \
        < _len(kv_len, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("hgk,hkd->hgd", p, v.to(torch.float32))
    return out.to(q.dtype)


def decode_attention_ref_4d(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor,
                            kv_len: KvLen) -> torch.Tensor:
    """Cache-native layout: NO transpose of the (huge) KV cache.

    q: (B, 1, HQ, D); caches: (B, S, KH, D).  Returns (B, 1, HQ, D).
    Masked positions get zero weight and the normalizer is clamped at
    1e-30, the kernel's contract: kv_len = 0 gives zeros (where the
    reference's jnp oracle, subtracting -inf from -inf, gives NaN)."""
    B, _, HQ, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = HQ // KH
    qg = q.reshape(B, KH, G, D).to(torch.float32) / (D ** 0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.to(torch.float32))
    valid = (torch.arange(S, device=q.device)
             < _len(kv_len, q.device))[None, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p / l.clamp_min(1e-30),
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, HQ, D).to(q.dtype)
