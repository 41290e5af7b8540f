"""Shared neural building blocks: norms, RoPE, MLPs, embeddings, linear
(with the VTA int8 quantized path as a first-class backend).

The port of the reference's ``models/layers.py``.  Parameters are nested
dicts of tensors; the init functions draw from an explicit
``torch.Generator`` with the reference's distributions (not its numbers:
the tests carry the reference's weights across instead), and take a
``lead`` shape so a stack of layers is drawn at once.  The math is plain
functions on tensors, in the reference's order of operations and dtypes.

Under a mesh whose "model" axis computes split (``meshctx.model_axis``),
the MLP runs column-parallel ``wi``/``wg`` and row-parallel ``wo`` on the
rank's slice of the hidden width, and the embedding is a vocab-parallel
lookup, each finished by ``reduce_from_model`` (the reference gets the
same from GSPMD under ``param_specs``); the caller hands them the rank's
slices of the weights.  With no such axis they are as on one device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import meshctx
from repro_torch.distributed.sharding import hidden_split, vocab_split
from repro_torch.kernels.vta_gemm import quantized_linear
from repro_torch.kernels.vta_gemm.ref import activation_scale
from repro_torch.trace import MLP, span

Params = Dict[str, Any]


def torch_dtype(cfg) -> torch.dtype:
    """The torch dtype named by ``cfg.dtype`` ("bfloat16", "float32")."""
    return getattr(torch, cfg.dtype)


# ----------------------------------------------------------------------
# linear (dense or VTA-quantized)
# ----------------------------------------------------------------------
def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, device: torch.device,
                lead: Tuple[int, ...] = ()) -> Params:
    """w ~ U(-1/sqrt(d_in), 1/sqrt(d_in)) in float32, stored in `dtype`."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.rand(lead + (d_in, d_out), generator=gen, device=device,
                   dtype=torch.float32)
    return {"w": (w * (2 * scale) - scale).to(dtype)}


def linear_apply(p: Params, x: torch.Tensor, cfg=None,
                 ax: Optional[meshctx.Axis] = None,
                 row: bool = False) -> torch.Tensor:
    """Dense matmul, or the VTA int8 path when the weights were quantized
    (serve-time PTQ): p == {"w_q": int8 (K, N), "w_scale": float32 (N,)}.

    Under a mesh (`cfg` given, its ambient axes read from ``meshctx``) the
    int8 path computes what the reference's ``quantized_linear`` computes
    on the global tensors under GSPMD.  `ax` is the "model" axis where it
    splits this layer: column-parallel (``row`` False), w_q holds the
    rank's N/tp columns and the layer takes the same columns of the
    replicated w_scale (a view); row-parallel (``row``), w_q holds the
    rank's K/tp rows, x the same columns of the activation, and w_scale is
    whole.  The activation's per-tensor scale is its global max|x|: the
    rank's max, all-reduced (MAX) over the data axes that split the batch
    and, for a row-parallel layer, over `ax` (``meshctx.max_over``).  With
    no such axis (no mesh) nothing is reduced and the call is as on one
    device."""
    if "w_q" not in p:
        return x @ p["w"].to(x.dtype)
    w_q, w_scale = p["w_q"], p["w_scale"]
    if ax is not None and not row and w_q.shape[1] != w_scale.shape[0]:
        n = w_q.shape[1]
        w_scale = w_scale[ax.rank * n:(ax.rank + 1) * n]
    axes = [a for a in (meshctx.data_axes(cfg) if cfg is not None else ())
            if a.size > 1]
    if row and ax is not None:
        axes.append(ax)
    x_scale = None
    if axes and x.numel():
        amax = meshctx.max_over(x.abs().amax().clamp_min(1e-6), axes)
        x_scale = activation_scale(amax)
    return quantized_linear(x, w_q, w_scale, x_scale)


def quantize_linear_params(p: Params) -> Params:
    """Symmetric per-channel PTQ of a dense linear layer: w (..., K, N) ->
    w_q (..., K, N) int8, a transposed view of contiguous (..., N, K)
    storage (the layout the int8 kernel reads in place), and w_scale
    (..., N) float32; each leading index (a layer of a stack) on its own."""
    w = p["w"].to(torch.float32)
    amax = w.abs().amax(dim=-2).clamp_min(1e-8)
    scale = amax / 127.0
    w_q = torch.round(w / scale[..., None, :]).clamp(-128, 127) \
        .to(torch.int8)
    return {"w_q": w_q.transpose(-1, -2).contiguous().transpose(-1, -2),
            "w_scale": scale}


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------
def norm_init(cfg, d: int, device: torch.device,
              lead: Tuple[int, ...] = ()) -> Params:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(lead + (d,), device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(lead + (d,), device=device),
                "bias": torch.zeros(lead + (d,), device=device)}
    if cfg.norm == "nonparametric":   # olmo: LN without affine params
        return {}
    raise ValueError(cfg.norm)


def norm_apply(cfg, p: Params, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        r = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (r * p["scale"]).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
    r = (xf - mu) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        r = r * p["scale"] + p["bias"]
    return r.to(x.dtype)


# ----------------------------------------------------------------------
# rotary position embedding
# ----------------------------------------------------------------------
def rope_frequencies(hd: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)               # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_embedding(S: int, d: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((S, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as the reference computes it: x * sigmoid(x), the
    sigmoid as 1 / (1 + exp(-x)), each step rounded in x's dtype (so a
    bfloat16 x rounds where the reference's does)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_init(gen: torch.Generator, cfg, d: int, d_ff: int,
             device: torch.device, lead: Tuple[int, ...] = ()) -> Params:
    dt = torch_dtype(cfg)
    if cfg.mlp == "swiglu":
        return {"wi": linear_init(gen, d, d_ff, dt, device, lead),
                "wg": linear_init(gen, d, d_ff, dt, device, lead),
                "wo": linear_init(gen, d_ff, d, dt, device, lead)}
    return {"wi": linear_init(gen, d, d_ff, dt, device, lead),
            "wo": linear_init(gen, d_ff, d, dt, device, lead)}


def mlp_apply(p: Params, x: torch.Tensor, cfg,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP of hidden width `d_ff` (default ``cfg.d_ff``).  Where the
    "model" axis splits it, p holds the rank's columns of wi/wg and rows
    of wo, and the partial outputs are summed over the axis."""
    with span(MLP):
        ax = meshctx.model_axis(cfg)
        if ax is not None and not hidden_split(d_ff or cfg.d_ff, ax.size):
            ax = None
        x = meshctx.copy_to_model(x, ax)
        if cfg.mlp == "swiglu":
            h = silu(linear_apply(p["wg"], x, cfg, ax)) \
                * linear_apply(p["wi"], x, cfg, ax)
        else:
            # jax.nn.gelu is the tanh approximation by default
            h = F.gelu(linear_apply(p["wi"], x, cfg, ax), approximate="tanh")
        return meshctx.reduce_from_model(
            linear_apply(p["wo"], h, cfg, ax, row=True), ax)


# ----------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------
def embed_init(gen: torch.Generator, cfg, device: torch.device) -> Params:
    dt = torch_dtype(cfg)
    p = {"tokens": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                                device=device) * 0.02).to(dt)}
    if cfg.pos == "learned":
        p["pos"] = (torch.randn((cfg.max_seq, cfg.d_model), generator=gen,
                                device=device) * 0.02).to(dt)
    return p


def embed_apply(p: Params, cfg, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token (and position) embedding.  Where the "model" axis splits the
    vocab, p["tokens"] holds the rank's V/tp rows: a token outside them
    looks up zeros, and the ranks' rows are summed over the axis."""
    ax = meshctx.model_axis(cfg)
    if ax is not None and vocab_split(cfg, ax.size):
        table = p["tokens"]
        lo = ax.rank * table.shape[0]
        local = tokens - lo
        mine = (local >= 0) & (local < table.shape[0])
        x = table[torch.where(mine, local, 0)] \
            * mine[..., None].to(table.dtype)
        x = meshctx.reduce_from_model(x, ax)
    else:
        x = p["tokens"][tokens]
    if cfg.pos in ("learned", "sinusoidal"):
        pos = positions if positions is not None \
            else torch.arange(tokens.shape[-1], device=tokens.device)
        if cfg.pos == "learned":
            x = x + p["pos"][pos]
        else:
            x = x + sinusoidal_embedding(cfg.max_seq, cfg.d_model,
                                         x.device)[pos].to(x.dtype)
    return x
