"""Mixture-of-Experts layer with sort-based capacity dispatch.

The port of the reference's ``models/moe.py`` for one device.  Token ->
expert pairs are sorted by expert id (a stable sort: the earlier pair
wins a place) and packed into a per-expert capacity buffer (E, C, d) of
static shape; pairs beyond the capacity C = ceil(T * k * cf / E) (at
least 8, rounded up to 8) are dropped.  Every expert then runs its
swiglu FFN over its whole buffer, used or not, as in the reference, and
each token sums its kept pairs' gated outputs.

At world size 1 the reference takes ``tp = 1`` and runs the local
dispatch whatever ``moe_fused_ep``, ``moe_combine``, ``moe_token_gather``,
``moe_expert_2d`` and ``seq_parallel_residual`` say; the port has no mesh
and does the same, so configs that set them (phi3.5-moe, kimi-k2) serve
unchanged.  The expert-parallel paths (``_route_local``,
``_shared_partial``, ``_moe_fused_ep`` and the ``shard_map`` branch of
``moe_apply``) are not ported yet (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .layers import mlp_apply, mlp_init, silu, torch_dtype

Params = Dict[str, Any]


def _uniform_stack(gen: torch.Generator, shape: Tuple[int, ...],
                   bound: float, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """U(-bound, bound) of `shape`, drawn in float32 one trailing (rows,
    cols) matrix at a time and stored in `dtype`: only one matrix's float32
    temporaries ever exist (a whole (L, E, d, f) stack in float32 would
    not fit beside the model on the card).  On the meta device: the
    shape alone."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for m in out.view(-1, *shape[-2:]):
        w = torch.rand(shape[-2:], generator=gen, device=device,
                       dtype=torch.float32)
        m.copy_(w * (2 * bound) - bound)
    return out


def moe_init(gen: torch.Generator, cfg, device: torch.device,
             lead: Tuple[int, ...] = ()) -> Params:
    """The reference's distributions: the router float32 U(+-1/sqrt(d));
    wi and wg U(+-1/sqrt(d)) and wo U(+-1/sqrt(f)), drawn in float32 and
    stored in ``cfg.dtype`` (bare (..., E, d, f) arrays, not {"w"} nodes);
    the shared experts an MLP of width n_shared_experts * f."""
    d, E = cfg.d_model, cfg.moe_experts
    f = cfg.moe_d_ff or cfg.d_ff
    dt = torch_dtype(cfg)
    s = 1.0 / math.sqrt(d)
    router = torch.rand(lead + (d, E), generator=gen, device=device,
                        dtype=torch.float32) * (2 * s) - s
    p: Params = {
        "router": {"w": router},
        "wi": _uniform_stack(gen, lead + (E, d, f), s, dt, device),
        "wg": _uniform_stack(gen, lead + (E, d, f), s, dt, device),
        "wo": _uniform_stack(gen, lead + (E, f, d), 1 / math.sqrt(f), dt,
                             device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d, cfg.n_shared_experts * f,
                               device, lead)
    return p


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    c = int(math.ceil(T * k * cf / E))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference does


def _route(cfg, xt: torch.Tensor, router_w: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with renormalized gates and the Switch-style aux
    loss: (top_i (T, k) int64, top_g (T, k) float32, aux).  The logits are
    float32 (``xt.float() @ w``).  The top k come from a stable descending
    sort, so equal probabilities take the lower expert first, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order on ties)."""
    k, E = cfg.moe_top_k, cfg.moe_experts
    probs = torch.softmax(xt.to(torch.float32) @ router_w, dim=-1)
    top_g, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[:, :k], top_i[:, :k]
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)
    frac = torch.nn.functional.one_hot(top_i[:, 0], E) \
        .to(torch.float32).mean(0)
    aux = E * torch.sum(frac * probs.mean(0))
    return top_i, top_g, aux


def dispatch_plan(flat_e: torch.Tensor, n_experts: int, C: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each token -> expert pair goes: `order` sorts the flat pairs
    by expert id (stable: the earlier flat index first); the pair at
    sorted position i takes slot `dest[i]` = e * C + (its place in expert
    e's segment) of the (E * C + 1)-row buffer when `keep[i]` (the place is
    below C), else the overflow row E * C, which is never read back."""
    Tk = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sid = flat_e[order]
    idx = torch.arange(Tk, device=flat_e.device)
    is_new = torch.ones(Tk, dtype=torch.bool, device=flat_e.device)
    is_new[1:] = sid[1:] != sid[:-1]
    starts = torch.cummax(torch.where(is_new, idx, 0), dim=0).values
    pos = idx - starts
    keep = pos < C
    dest = torch.where(keep, sid * C + pos, n_experts * C)
    return order, dest, keep


def _expert_ffn(buf: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d): each expert's swiglu over its buffer."""
    dt = buf.dtype
    h = silu(torch.bmm(buf, wg.to(dt))) * torch.bmm(buf, wi.to(dt))
    return torch.bmm(h, wo.to(dt))


def _dispatch_compute_combine(xt: torch.Tensor, flat_e: torch.Tensor,
                              flat_g: torch.Tensor, k: int, C: int,
                              wi: torch.Tensor, wg: torch.Tensor,
                              wo: torch.Tensor) -> torch.Tensor:
    """xt (T, d); flat_e / flat_g (T * k,) expert ids and gates.  Returns
    the experts' gated sum (T, d) in xt's dtype.  Each token adds its k
    contributions into zeros one at a time, in the order of the sorted
    pairs (ascending expert id), each product and sum rounded to xt's
    dtype: the order in which the reference's scatter-add takes them."""
    T, d = xt.shape
    E = wi.shape[0]
    order, dest, _ = dispatch_plan(flat_e, E, C)
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[order // k]
    out = _expert_ffn(buf[:E * C].view(E, C, d), wi, wg, wo)
    out_pad = torch.cat([out.reshape(E * C, d),
                         torch.zeros((1, d), dtype=xt.dtype,
                                     device=xt.device)])
    contrib = out_pad[dest] * flat_g[order][:, None].to(xt.dtype)
    # each token's sorted positions, ascending: its pairs in sorted order
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=xt.device)
    parts = contrib[rank.view(T, k).sort(dim=1).values]       # (T, k, d)
    y = torch.zeros((T, d), dtype=xt.dtype, device=xt.device)
    for j in range(k):
        y = y + parts[:, j]
    return y


def moe_apply(p: Params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss): the reference's route at
    world size 1.  The B * S tokens share one capacity (a decode step
    routes every slot, empty ones included, as the reference does)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    k, E = cfg.moe_top_k, cfg.moe_experts
    top_i, top_g, aux = _route(cfg, xt, p["router"]["w"])
    C = _capacity(T, k, E, cfg.moe_capacity_factor)
    y = _dispatch_compute_combine(xt, top_i.reshape(-1), top_g.reshape(-1),
                                  k, C, p["wi"], p["wg"], p["wo"])
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], xt, cfg)
    return y.reshape(B, S, d), aux
