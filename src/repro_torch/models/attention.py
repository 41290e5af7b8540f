"""GQA attention with KV cache: prefill and decode modes, the whisper
encoder's full-sequence pass and its decoder's cross-attention.

The port of the reference's ``models/attention.py``.  Training
(``attn_train``), prefill, the encoder and cross-attention run the
``flash_attention`` op and decode the ``decode_attention`` op; each picks
its kernel or plain version by the device of its tensors.
``flash_attention`` carries a gradient (its backward is a kernel on the
card); ``decode_attention`` serves only and raises on the card where an
operand requires grad.  Caches are written in place (the reference
returns updated copies): the cache dict is returned so the call sites
read as the reference's.

Where the "model" axis splits the heads (``sharding.heads_split``:
``HQ % tp == 0`` and ``KH % tp == 0``), the train forms run on the rank's
HQ/tp query and KH/tp KV heads (its columns of wq/wk/wv, its rows of
wo), so the GQA group is unchanged and the flash kernels launch at the
local shapes; the row-parallel wo's partial outputs are summed over the
axis (``reduce_from_model``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.distributed import meshctx
from repro_torch.distributed.sharding import heads_split
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.trace import ATTENTION, span

from .layers import apply_rope, linear_apply, linear_init, torch_dtype

Params = Dict[str, Any]


def attn_init(gen: torch.Generator, cfg, device: torch.device,
              lead: Tuple[int, ...] = ()) -> Params:
    d, dt = cfg.d_model, torch_dtype(cfg)
    return {"wq": linear_init(gen, d, cfg.q_dim, dt, device, lead),
            "wk": linear_init(gen, d, cfg.kv_dim, dt, device, lead),
            "wv": linear_init(gen, d, cfg.kv_dim, dt, device, lead),
            "wo": linear_init(gen, cfg.q_dim, d, dt, device, lead)}


def _heads(cfg) -> Tuple[Optional[meshctx.Axis], int, int]:
    """(the model axis where it splits the heads, else None; this rank's
    query heads; its KV heads)."""
    ax = meshctx.model_axis(cfg)
    if ax is None or not heads_split(cfg, ax.size):
        return None, cfg.n_heads, cfg.n_kv_heads
    return ax, cfg.n_heads // ax.size, cfg.n_kv_heads // ax.size


def _qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    ax, hq, kh = _heads(cfg)
    x = meshctx.copy_to_model(x, ax)
    q = linear_apply(p["wq"], x, cfg, ax).reshape(B, S, hq, cfg.hd)
    k = linear_apply(p["wk"], x, cfg, ax).reshape(B, S, kh, cfg.hd)
    v = linear_apply(p["wv"], x, cfg, ax).reshape(B, S, kh, cfg.hd)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(p: Params, cfg, x: torch.Tensor, *, causal: bool = True,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over the whole sequence x (B, S, d), no cache: the train
    mode of every attention block, and the whisper encoder's pass
    (``causal=False``).  Differentiable: the gradient of the attention
    itself is the flash_attention op's backward (a kernel on the card)."""
    with span(ATTENTION):
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        q, k, v = _qkv(p, cfg, x, positions)
        o = flash_attention(q, k, v, causal=causal)
        return _out(p, cfg, o)


def _out(p: Params, cfg, o: torch.Tensor) -> torch.Tensor:
    """wo over the attention output o (B, S, heads, hd): the rank's rows
    of wo summed over the model axis where it splits the heads."""
    B, S = o.shape[:2]
    ax, _, _ = _heads(cfg)
    y = linear_apply(p["wo"], o.reshape(B, S, -1), cfg, ax, row=True)
    return meshctx.reduce_from_model(y, ax)


def init_kv_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                  device: torch.device,
                  lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_cache_quant:
        # VTA-style int8 cache: per-(token, head) symmetric scales
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], device=device),
                "v_s": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quant_kv(x: torch.Tensor):
    """(B, S, KH, D) -> int8 values + (B, S, KH) float32 scales."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1).clamp_min(1e-6)
    scale = amax / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-128, 127).to(torch.int8)
    return q, scale


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _write_at(cache: Dict[str, torch.Tensor], start: int, k: torch.Tensor,
              v: torch.Tensor, quant: bool) -> None:
    """Write k, v (B, n, KH, D) into the cache at positions [start,
    start + n), in place.  The start is clamped so the update fits, as
    ``jax.lax.dynamic_update_slice`` clamps it."""
    n = k.shape[1]
    start = max(0, min(int(start), cache["k"].shape[1] - n))
    if quant:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        cache["k"][:, start:start + n] = kq
        cache["v"][:, start:start + n] = vq
        cache["k_s"][:, start:start + n] = ks
        cache["v_s"][:, start:start + n] = vs
    else:
        cache["k"][:, start:start + n] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + n] = v.to(cache["v"].dtype)


def attn_prefill(p: Params, cfg, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full causal pass over the prompt; writes positions [0, S) of the
    cache in place."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(p, cfg, x, positions)
    o = flash_attention(q, k, v, causal=True)
    _write_at(cache, 0, k, v, cfg.kv_cache_quant)
    return _out(p, cfg, o), cache


def attn_decode(p: Params, cfg, x: torch.Tensor,
                cache: Dict[str, torch.Tensor],
                pos: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step: x (B, 1, d); pos the current index (an int), the
    same for every row.  Writes position pos of the cache in place and
    attends over positions [0, pos]."""
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    _write_at(cache, pos, k, v, cfg.kv_cache_quant)
    if cfg.kv_cache_quant:
        k_cache = _dequant_kv(cache["k"], cache["k_s"], x.dtype)
        v_cache = _dequant_kv(cache["v"], cache["v_s"], x.dtype)
    else:
        k_cache, v_cache = cache["k"], cache["v"]
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    return _out(p, cfg, o), cache


def cross_attn_init(gen: torch.Generator, cfg, device: torch.device,
                    lead: Tuple[int, ...] = ()) -> Params:
    return attn_init(gen, cfg, device, lead)


def cross_attn_apply(p: Params, cfg, x: torch.Tensor,
                     enc_kv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Decoder cross-attention (whisper): x (B, S, d) over the encoder's
    K/V (B, T, KH, hd), non-causal.  K/V may be in another dtype than x
    (the decode step reads them from the cache): the op promotes."""
    B, S, _ = x.shape
    ax, hq, _ = _heads(cfg)
    x = meshctx.copy_to_model(x, ax)
    q = linear_apply(p["wq"], x, cfg, ax).reshape(B, S, hq, cfg.hd)
    o = flash_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return _out(p, cfg, o)


def encode_cross_kv(p: Params, cfg,
                    enc_out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """K and V (B, T, KH, hd) of the encoder output (B, T, d), in its
    dtype."""
    B, T, _ = enc_out.shape
    ax, _, kh = _heads(cfg)
    enc_out = meshctx.copy_to_model(enc_out, ax)
    k = linear_apply(p["wk"], enc_out, cfg, ax).reshape(
        B, T, kh, cfg.hd)
    v = linear_apply(p["wv"], enc_out, cfg, ax).reshape(
        B, T, kh, cfg.hd)
    return {"k": k, "v": v}
