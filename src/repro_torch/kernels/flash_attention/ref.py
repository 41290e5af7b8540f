"""Plain PyTorch versions of GQA softmax attention with a causal mask
(float32 math, output in q's dtype).

Two forms, as in the reference's ``flash_attention/ref.py``:
  * attention_ref         — materialized (S, Sk) scores;
  * attention_ref_chunked — a loop over kv blocks with a running softmax
    on the native (B, S, H, D) layout: peak memory is one (S, bk) block
    per head instead of (S, Sk).
And a model of the float32 CUDA kernel's arithmetic (3xTF32 products),
``attention_tf32x3_model``, which the CPU tests hold to a float64 oracle.
The backward, ``attention_bwd_ref``, is written out as FlashAttention-2's
formulas (no autograd), with a loop over key blocks for long sequences;
it takes the forward's log-sum-exp of each row (``attention_lse_ref``,
the plain version of what the kernels save) or recomputes it.

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
from typing import Optional, Tuple

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


def _row_stats(qg: torch.Tensor, k: torch.Tensor, *, causal: bool, S: int,
               Sk: int, bk: int, scale: float) -> torch.Tensor:
    """The log-sum-exp of each query row's scaled scores over the keys it
    sees, (B, KH, G, S, 1), by a running max and sum over key blocks of
    bk; +inf for a row that sees no key (its weights are then 0)."""
    B, _, KH, G, _ = qg.shape
    m = torch.full((B, KH, G, S, 1), NEG_INF, dtype=qg.dtype,
                   device=qg.device)
    l = torch.zeros_like(m)
    for k0 in range(0, Sk, bk):
        n = min(bk, Sk - k0)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                         k[:, k0:k0 + n].to(qg.dtype)) * scale
        if causal:
            mask = _causal_mask(S, Sk, qg.device, k0, n)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if causal:
            p = torch.where(mask, p, torch.zeros_like(p))
        l = l * torch.exp(m - m_new) + p.sum(dim=-1, keepdim=True)
        m = m_new
    return torch.where(l > 0, m + torch.log(l),
                       torch.full_like(l, math.inf))


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, group: int,
                      causal: bool = True, bk: int = 0,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The log-sum-exp L of each query row's scaled scores over the keys it
    sees, as the forward kernels save it for the backward: q (B, S, HQ,
    D), k (B, Sk, KH, D); returns (B, HQ, S) in `dtype`, +inf for a row
    that sees no key.  Keys in blocks of bk (the backward's default)."""
    B, S, HQ, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if not bk:
        bk = Sk if S * Sk <= 2048 * 2048 else 1024
    qg = q.to(dtype).reshape(B, S, KH, group, D)
    lse = _row_stats(qg, k, causal=causal, S=S, Sk=Sk, bk=max(1, bk),
                     scale=1.0 / math.sqrt(D))
    return lse.reshape(B, HQ, S)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *, group: int,
                      causal: bool = True, bk: int = 0,
                      dtype: torch.dtype = torch.float32,
                      operands: Optional[torch.dtype] = None,
                      lse: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of attention: q, o (the forward's output) and do (the
    gradient of o) (B, S, HQ, D); k, v (B, Sk, KH, D); group = HQ // KH.
    Returns (dq, dk, dv) in the dtypes of q, k and v.

    FlashAttention-2's formulas, computed in `dtype` (float32; float64 for
    an oracle), not autograd of a forward: P is recomputed from each row's
    log-sum-exp L (P = exp(S / sqrt(D) - L) over the keys the row sees;
    L is the forward's, (B, HQ, S) as :func:`attention_lse_ref` returns
    it, where `lse` is given, else recomputed by the same function),
    Delta = rowsum(dO * O), dV = P^T dO, dP = dO V^T, dS = P * (dP - Delta),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D).  dK and dV sum over each KV
    head's `group` query heads.  The causal diagonal is aligned
    bottom-right, as the forward's; a row that sees no key has zero
    gradient.  Keys are taken in blocks of bk (default: all of them up to
    2048^2 scores per head, 1024 above), so memory holds one (S, bk) block
    of scores per head.  With `operands` (torch.bfloat16), P and dS are
    rounded to it where they enter a product, as the bf16 kernel rounds
    its A operands; dS is formed from the unrounded P."""
    B, S, HQ, D = q.shape
    _, Sk, KH, _ = k.shape
    if not bk:
        bk = Sk if S * Sk <= 2048 * 2048 else 1024
    bk = max(1, bk)
    scale = 1.0 / math.sqrt(D)
    qg = q.to(dtype).reshape(B, S, KH, group, D)
    dog = do.to(dtype).reshape(B, S, KH, group, D)
    if lse is None:
        lse = attention_lse_ref(q, k, group=group, causal=causal, bk=bk,
                                dtype=dtype)
    lse = lse.to(dtype).reshape(B, KH, group, S, 1)
    delta = (dog * o.to(dtype).reshape(B, S, KH, group, D)).sum(-1) \
        .permute(0, 2, 3, 1)[..., None]                 # (B, KH, G, S, 1)
    dq = torch.zeros_like(qg)
    dk = torch.zeros((B, Sk, KH, D), dtype=dtype, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, Sk, bk):
        n = min(bk, Sk - k0)
        kj = k[:, k0:k0 + n].to(dtype)
        vj = v[:, k0:k0 + n].to(dtype)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj) * scale
        p = torch.exp(s - lse)                          # (B, KH, G, S, n)
        if causal:
            mask = _causal_mask(S, Sk, q.device, k0, n)
            p = torch.where(mask, p, torch.zeros_like(p))
        p_op = p if operands is None else p.to(operands).to(dtype)
        dv[:, k0:k0 + n] = torch.einsum("bhgqk,bqhgd->bkhd", p_op, dog)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vj)
        ds = p * (dp - delta)
        if operands is not None:
            ds = ds.to(operands).to(dtype)
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kj) * scale
        dk[:, k0:k0 + n] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(B, S, HQ, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
