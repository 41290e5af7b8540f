"""Mamba2 (state-space duality) blocks and the chunked GLA core: the port
of the reference's ``models/ssm.py``.

The SSD recurrence  h_t = a_t h_{t-1} + k_t v_tᵀ,  y_t = q_t · h_t  (a
per-head scalar decay a_t) covers Mamba2 (q = C, k = B, v = dt x,
a = exp(dt A)).  Training and prefill run it chunk by chunk through the
``gla_chunk`` op (its CUDA kernel on the card, its plain version on the
CPU; in training its gradient is the op's backward, a kernel of its own
on the card); decode takes one step of it per token (``gla_step``, plain
PyTorch: two small products, no kernel in the reference either).

The math keeps the reference's dtypes: the conv state has the cache's
dtype, and concatenating it with a bfloat16 input promotes to float32 as
``jnp.concatenate`` does; softplus, the decay and v are float32; y comes
back from the scan in float32.  Caches are updated in place (the
reference returns updated copies); each function returns the cache dict
so the call sites read as the reference's.  ``mamba2_train`` runs with
no cache, from zero conv and SSM states.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.gla_chunk import gla_chunk
from repro_torch.trace import MAMBA2, MAMBA2_IN_PROJ, MAMBA2_OUT_PROJ, span

from .layers import (linear_apply, linear_init, norm_apply, norm_init, silu,
                     torch_dtype)

Params = Dict[str, Any]


# ----------------------------------------------------------------------
# chunked gated linear attention
# ----------------------------------------------------------------------
def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_a: torch.Tensor, chunk: int = 128,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, S, H, N), or (B, S, 1, N) for every head; v: (B, S, H,
    P); log_a: (B, S, H) (<= 0 decay).
    Returns y (B, S, H, P) and the final state h (B, H, N, P), both
    float32.  min(chunk, S) must divide S, as in the reference.

    y_t = q_t · (sum_{s<=t} exp(L_t - L_s) k_s v_sᵀ + exp(L_t) h0)
    """
    return gla_chunk(q, k, v.to(torch.float32), log_a.to(torch.float32),
                     h0, chunk=chunk, y_dtype=torch.float32)


def gla_step(h: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, a: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  h: (B, H, N, P); q, k: (B, H, N); v: (B, H, P);
    a: (B, H).  Returns the new h and y (B, H, P)."""
    h = h * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", k.to(torch.float32), v.to(torch.float32))
    y = torch.einsum("bhn,bhnp->bhp", q.to(torch.float32), h)
    return h, y


# ----------------------------------------------------------------------
# Mamba2 block
# ----------------------------------------------------------------------
def mamba2_init(gen: torch.Generator, cfg, device: torch.device,
                lead: Tuple[int, ...] = ()) -> Params:
    """The reference's parameters and distributions (not its numbers)."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = torch_dtype(cfg)
    conv_ch = di + 2 * N
    conv_w = torch.randn(lead + (cfg.ssm_conv, conv_ch), generator=gen,
                         device=device) * (1.0 / math.sqrt(cfg.ssm_conv))
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    return {
        # z, x, B, C, dt
        "in_proj": linear_init(gen, d, 2 * di + 2 * N + H, dt, device, lead),
        "out_proj": linear_init(gen, di, d, dt, device, lead),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dt, device=device),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), device=device),
        "dt_bias": torch.zeros(lead + (H,), device=device),
        "norm": norm_init(cfg, di, device, lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, S, C); w: (W, C).  Returns (y,
    new_state), the state being the last W-1 inputs (in the promoted dtype
    of the state and x, as in the reference)."""
    B, S, C = x.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                # (B, S+W-1, C)
    y = sum(xp[:, i:i + S, :] * w[i][None, None] for i in range(W)) + b
    new_state = xp[:, S:, :] if W > 1 else state
    return y, new_state


def _ssm_inner(cfg, p: Params, zxbcdt: torch.Tensor,
               conv_state: Optional[torch.Tensor],
               ssm_state: Optional[torch.Tensor], chunked: bool):
    """The computation after in_proj, shared by prefill (chunked) and
    decode (one step).  Returns (y, new conv state, new ssm state)."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    Pd = cfg.ssm_head_dim
    B_, S, _ = zxbcdt.shape
    z = zxbcdt[..., :di]                       # gate branch
    xBC = zxbcdt[..., di:2 * di + 2 * N]       # conv channels (x, B, C)
    dt_raw = zxbcdt[..., 2 * di + 2 * N:]      # per-head dt logits (H)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                   conv_state)
    xBC = silu(xBC)
    x = xBC[..., :di].reshape(B_, S, H, Pd)
    Bmat = xBC[..., di:di + N]
    Cmat = xBC[..., di + N:]
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt_raw.to(torch.float32) + p["dt_bias"],
                         torch.zeros((), device=zxbcdt.device))   # (B,S,H)
    A = -torch.exp(p["A_log"])                                    # (H,)
    log_a = dt * A[None, None, :]
    v = x.to(torch.float32) * dt[..., None]
    # one row for every head: the op broadcasts them (stride-0 views, read
    # in place by the kernel) and sums their gradient over the heads
    q = Cmat[:, :, None, :]
    k = Bmat[:, :, None, :]
    if chunked:
        # chunk ~ state dim N: larger chunks make the intra-chunk
        # quadratic dominate FLOPs; smaller waste the scan
        y, ssm_state = chunked_gla(q, k, v, log_a, chunk=max(32, N),
                                   h0=ssm_state)
    else:
        a = torch.exp(log_a[:, 0])                                # (B,H)
        ssm_state, y = gla_step(ssm_state, q[:, 0].expand(B_, H, N),
                                k[:, 0].expand(B_, H, N), v[:, 0], a)
        y = y[:, None]
    y = y + x.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(B_, S, di).to(z.dtype)
    y = norm_apply(cfg, p["norm"], y * silu(z))
    return y, conv_state, ssm_state


def mamba2_train(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); the chunked scan from zero states, no cache."""
    with span(MAMBA2):
        with span(MAMBA2_IN_PROJ):
            zxbcdt = linear_apply(p["in_proj"], x, cfg)
        y, _, _ = _ssm_inner(cfg, p, zxbcdt, None, None, chunked=True)
        with span(MAMBA2_OUT_PROJ):
            return linear_apply(p["out_proj"], y, cfg)


def init_ssm_cache(cfg, batch: int, dtype: torch.dtype,
                   device: torch.device,
                   lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """The conv state (the last ssm_conv - 1 inputs) in `dtype`, the SSM
    state in float32; zeros."""
    di, N = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, cfg.ssm_heads, N,
                                   cfg.ssm_head_dim), device=device),
    }


def _mamba2(p: Params, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
            chunked: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    zxbcdt = linear_apply(p["in_proj"], x, cfg)
    y, conv_state, ssm_state = _ssm_inner(cfg, p, zxbcdt, cache["conv"],
                                          cache["ssm"], chunked)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(ssm_state)
    return linear_apply(p["out_proj"], y, cfg), cache


def mamba2_prefill(p: Params, cfg, x: torch.Tensor,
                   cache: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) from the cache's state; the chunked scan.  The cache
    is updated in place."""
    return _mamba2(p, cfg, x, cache, chunked=True)


def mamba2_decode(p: Params, cfg, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d); an O(1) state update.  The cache is updated in
    place."""
    return _mamba2(p, cfg, x, cache, chunked=False)
