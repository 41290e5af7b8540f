"""Plain PyTorch versions of GQA softmax attention with a causal mask
(float32 math, output in q's dtype).

Two forms, as in the reference's ``flash_attention/ref.py``:
  * attention_ref         — materialized (S, Sk) scores;
  * attention_ref_chunked — a loop over kv blocks with a running softmax
    on the native (B, S, H, D) layout: peak memory is one (S, bk) block
    per head instead of (S, Sk).
And a model of the float32 CUDA kernel's arithmetic (3xTF32 products),
``attention_tf32x3_model``, which the CPU tests hold to a float64 oracle.

The causal diagonal is aligned bottom-right: query row i (of S) sees key
j (of Sk) when j <= i + (Sk - S), the reference oracles' mask.  Masked
positions get zero weight and the normalizer is clamped at 1e-30 (the
kernels' contract), which is softmax over the visible keys.  A row that
sees no key at all (causal with Sk < S) gives zeros, where the reference's
materialized oracle gives the mean of v (softmax over a row of -1e30) and
its chunked one NaN (-inf minus -inf).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def _causal_mask(S: int, Sk: int, device: torch.device,
                 k0: int = 0, bk: int = 0) -> torch.Tensor:
    """(S, bk or Sk) bool: key k0 + j visible to query row i."""
    n = bk or Sk
    q_pos = torch.arange(S, device=device)[:, None] + (Sk - S)
    k_pos = k0 + torch.arange(n, device=device)[None, :]
    return k_pos <= q_pos


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  group: int, causal: bool = True) -> torch.Tensor:
    """q: (B*HQ, S, D); k/v: (B*KH, Sk, D); group = HQ // KH."""
    BH, S, D = q.shape
    Sk = k.shape[1]
    kv = torch.repeat_interleave(k, group, dim=0)
    vv = torch.repeat_interleave(v, group, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.to(torch.float32),
                     kv.to(torch.float32)) / (D ** 0.5)
    if causal:
        mask = _causal_mask(S, Sk, q.device)[None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("hqk,hkd->hqd", p, vv.to(torch.float32))
    return out.to(q.dtype)


def attention_ref_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, group: int, causal: bool = True,
                          bk: int = 1024) -> torch.Tensor:
    """q: (B, S, HQ, D); k/v: (B, Sk, KH, D).  A running softmax over kv
    blocks of bk positions (the last block may be shorter)."""
    B, S, HQ, D = q.shape
    _, Sk, KH, _ = k.shape
    scale = 1.0 / (D ** 0.5)
    qg = (q.to(torch.float32) * scale).reshape(B, S, KH, group, D)
    m = torch.full((B, KH, group, S, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KH, group, S, D), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, Sk, bk):
        n = min(bk, Sk - k0)
        kj = k[:, k0:k0 + n].to(torch.float32)           # (B, n, KH, D)
        vj = v[:, k0:k0 + n].to(torch.float32)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj)    # (B,KH,G,S,n)
        if causal:
            mask = _causal_mask(S, Sk, q.device, k0, n)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if causal:
            p = torch.where(mask, p, torch.zeros_like(p))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)                      # (B,KH,G,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, HQ, D).to(q.dtype)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 x as the kernel's two TF32 halves: hi, x rounded to TF32
    to nearest on the magnitude bits (hopper.cuh ``tf32``), and lo = x -
    hi as the tensor cores read it, truncated to TF32."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: hi·hi + (lo·hi + hi·lo), each product exact in
    float32 and summed in float32, the small two added last."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def attention_tf32x3_model(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True
                           ) -> torch.Tensor:
    """The float32 kernel's arithmetic on the CPU: q (B, S, HQ, D) scaled
    by 1/sqrt(D) before the product, k and v (B, Sk, KH, D); scores and
    the weighted sum of v in 3xTF32, the softmax in float32 over the
    visible keys (the kernel's online rescaling adds float32 roundings
    only).  Returns (B, S, HQ, D) float32."""
    B, S, HQ, D = q.shape
    _, Sk, KH, _ = k.shape
    group = HQ // KH
    qh = (q.float() * (1.0 / math.sqrt(D))).transpose(1, 2)
    kh = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vh = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    s = matmul_tf32x3(qh, kh.transpose(-1, -2).contiguous())
    if causal:
        mask = _causal_mask(S, Sk, q.device)
        s = torch.where(mask, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (matmul_tf32x3(p, vh.contiguous()) / l).transpose(1, 2)
