"""Mixture-of-Experts layer with sort-based capacity dispatch.

The port of the reference's ``models/moe.py`` for one device.  Token ->
expert pairs are sorted by expert id (a stable sort: the earlier pair
wins a place) and packed into a per-expert capacity buffer (E, C, d) of
static shape; pairs beyond the capacity C = ceil(T * k * cf / E) (at
least 8, rounded up to 8) are dropped.  Every expert then runs its
swiglu FFN over its whole buffer, used or not, as in the reference, and
each token sums its kept pairs' gated outputs.

With no mesh (serving, one device) ``tp = 1`` and the layer runs the
local dispatch whatever ``moe_fused_ep``, ``moe_combine``,
``moe_token_gather`` and ``moe_expert_2d`` say, as the reference does at
world size 1.  Under the trainer's mesh (``meshctx``) the layer takes the
reference's branches by its conditions:

* expert parallelism where the "model" axis (size tp) divides E: each
  model rank holds E/tp experts at offset rank * E/tp (``wi``/``wg``/
  ``wo`` are its slices) and dispatches the tokens of its data shard to
  them, the capacity from that shard (``T // dp``, or the whole batch
  under ``moe_expert_2d``); the ranks' partial outputs are combined over
  "model" by ``psum`` or ``psum_bf16`` (summed in bfloat16).  Where the
  reference enters ``shard_map``, the port calls ``meshctx``'s
  collectives.  The port's residual is replicated over "model", so two
  of the reference's flags map onto other branches with the same values
  and gradients: ``moe_combine="reduce_scatter"`` (a bfloat16
  reduce-scatter of token-sharded output) is the ``psum_bf16`` combine,
  falling back to ``psum`` where the rows do not split over "model" as
  the reference does, and ``moe_token_gather`` (an all-gather of
  token-sharded input) is the replicated tokens entering the split
  compute.  A sequence-sharded residual (ROADMAP Queue 1) is what would
  give those two their own form;
* ``_moe_fused_ep`` where ``moe_fused_ep`` is set and the rows split over
  "model": routing on each model rank, the shared expert as each rank's
  slice of its hidden width, one combine;
* the data-parallel form where no model axis splits the experts but data
  axes split the batch: the reference routes and drops over the whole
  global batch (GSPMD), so the port gathers the tokens over the data
  axes, dispatches them all and keeps its own rows.

The aux loss is the whole batch's on every rank (its partial sums are
summed over the data axes).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed import meshctx
from repro_torch.distributed.sharding import (experts_split, hidden_split,
                                              shared_expert_width)

from .layers import linear_apply, mlp_apply, mlp_init, silu, torch_dtype

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


def _route_local(cfg, xt: torch.Tensor, router_w: torch.Tensor):
    """The routing of the expert-parallel paths: (flat_e (T * k,) int64,
    flat_g (T * k,) float32, (count_sum (E,), prob_sum (E,))), the aux
    loss's per-expert partial sums over these T tokens (the count of
    tokens whose first choice is each expert, the sum of its
    probabilities)."""
    k, E = cfg.moe_top_k, cfg.moe_experts
    probs = torch.softmax(xt.to(torch.float32) @ router_w, dim=-1)
    top_g, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[:, :k], top_i[:, :k]
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = torch.nn.functional.one_hot(top_i[:, 0], E).to(torch.float32)
    return (top_i.reshape(-1), top_g.reshape(-1),
            (onehot.sum(0), probs.sum(0)))


def _shared_partial(cfg, xt: torch.Tensor, sh: Params, ax) -> torch.Tensor:
    """The shared experts' output from a model rank's slice of their
    hidden width (a partial sum, completed by the expert-parallel
    combine): wg and wi column-parallel, wo row-parallel over `ax`, float
    or int8 (``linear_apply``)."""
    h = silu(linear_apply(sh["wg"], xt, cfg, ax)) \
        * linear_apply(sh["wi"], xt, cfg, ax)
    return linear_apply(sh["wo"], h, cfg, ax, row=True)


def dispatch_plan(flat_e: torch.Tensor, n_experts: int, C: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each token -> expert pair goes: `order` sorts the flat pairs
    by expert id (stable: the earlier flat index first); the pair at
    sorted position i takes slot `dest[i]` = e * C + (its place in expert
    e's segment) of the (E * C + 1)-row buffer when `keep[i]` (an id below
    `n_experts` and a place below C), else the overflow row E * C, which
    is never read back.  An expert shard passes ids relative to its first
    expert, ``n_experts`` for the pairs of other shards."""
    Tk = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sid = flat_e[order]
    idx = torch.arange(Tk, device=flat_e.device)
    is_new = torch.ones(Tk, dtype=torch.bool, device=flat_e.device)
    is_new[1:] = sid[1:] != sid[:-1]
    starts = torch.cummax(torch.where(is_new, idx, 0), dim=0).values
    pos = idx - starts
    keep = (pos < C) & (sid < n_experts)
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
                              wo: torch.Tensor, e_offset: int = 0,
                              expert_ffn=None) -> torch.Tensor:
    """xt (T, d); flat_e / flat_g (T * k,) expert ids and gates; wi / wg /
    wo the experts e_offset .. e_offset + E_local - 1 (all of them at
    offset 0).  Returns those experts' gated sum (T, d) in xt's dtype
    (zeros from the pairs of other experts).  Each token adds its k
    contributions into zeros one at a time, in the order of the sorted
    pairs (ascending expert id), each product and sum rounded to xt's
    dtype: the order in which the reference's scatter-add takes them.
    `expert_ffn` replaces the experts' FFN (the 2-D resident layout)."""
    T, d = xt.shape
    E = wi.shape[0]
    local = flat_e - e_offset
    local = torch.where((local >= 0) & (local < E), local, E)
    order, dest, _ = dispatch_plan(local, E, C)
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[order // k]
    ffn = expert_ffn or (lambda b: _expert_ffn(b, wi, wg, wo))
    out = ffn(buf[:E * C].view(E, C, d))
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


def _aux(cfg, counts: torch.Tensor, probs: torch.Tensor,
         dp_axes) -> torch.Tensor:
    """The Switch-style aux loss from the per-expert partial sums of
    `_route_local`, summed over the data axes first."""
    counts = meshctx.all_reduce_data(counts, dp_axes)
    probs = meshctx.all_reduce_data(probs, dp_axes)
    n = counts.sum().clamp_min(1.0)
    return cfg.moe_experts * torch.sum((counts / n) * (probs / n))


def _combine(y: torch.Tensor, combine: str, ax, dtype) -> torch.Tensor:
    """The experts' partial outputs summed over the model axis, as the
    reference's combine: psum in y's dtype, or psum_bf16 (and
    reduce_scatter, module docstring) in bfloat16."""
    if combine in ("psum_bf16", "reduce_scatter"):
        return meshctx.reduce_from_model(y.to(torch.bfloat16),
                                         ax).to(dtype)
    return meshctx.reduce_from_model(y, ax)


def _moe_local(p: Params, cfg, xt: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-device layer over the rows xt (T, d): (experts' output,
    aux); the shared experts are the caller's."""
    k, E = cfg.moe_top_k, cfg.moe_experts
    top_i, top_g, aux = _route(cfg, xt, p["router"]["w"])
    C = _capacity(xt.shape[0], k, E, cfg.moe_capacity_factor)
    y = _dispatch_compute_combine(xt, top_i.reshape(-1), top_g.reshape(-1),
                                  k, C, p["wi"], p["wg"], p["wo"])
    return y, aux


def moe_apply(p: Params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss).  With no mesh the
    reference's route at world size 1: the B * S tokens share one
    capacity (a decode step routes every slot, empty ones included, as
    the reference does).  Under a mesh, the branch the reference's
    conditions choose (module docstring); x is this rank's rows of the
    batch, replicated over "model"."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    k, E = cfg.moe_top_k, cfg.moe_experts
    ax = meshctx.model_axis(cfg)
    if ax is not None and not experts_split(cfg, ax.size):
        ax = None
    dp_axes = meshctx.data_axes(cfg)
    dp = math.prod(a.size for a in dp_axes)
    tp = ax.size if ax is not None else 1
    shared = cfg.n_shared_experts and ("shared" in p)

    if ax is not None and cfg.moe_fused_ep and T % tp == 0:
        return _moe_fused_ep(p, cfg, xt, ax, dp_axes, B, S)

    if ax is None:
        if dp > 1:      # the data-parallel form: route the global batch
            y, aux = _moe_local(p, cfg, meshctx.gather_data(xt, dp_axes))
            y = meshctx.data_block(y, dp_axes)
        else:
            y, aux = _moe_local(p, cfg, xt)
        if shared:
            y = y + mlp_apply(p["shared"], xt, cfg,
                              d_ff=shared_expert_width(cfg))
        return y.reshape(B, S, d), aux

    n_local = E // tp
    e_off = ax.rank * n_local
    if dp > 1:
        flat_e, flat_g, (cnt, psum_probs) = _route_local(
            cfg, xt, p["router"]["w"])
        aux = _aux(cfg, cnt, psum_probs, dp_axes)
    else:
        top_i, top_g, aux = _route(cfg, xt, p["router"]["w"])
        flat_e, flat_g = top_i.reshape(-1), top_g.reshape(-1)
    expert_2d = bool(cfg.moe_expert_2d and dp_axes and d % dp == 0)
    C = _capacity(max(1, T * dp if expert_2d else T), k, E,
                  cfg.moe_capacity_factor)
    combine = cfg.moe_combine
    if combine == "reduce_scatter" and T % tp:
        combine = "psum"   # decode batches too small to scatter
    ffn2d = None
    xs, fe, fg = xt, flat_e, flat_g
    if expert_2d:
        # the experts' 2-D resident layout: each data rank contracts its
        # slice of d over every token of the batch (the tokens gathered
        # over the data axes), the partial products summed over them
        xs = meshctx.gather_data(xt, dp_axes)
        fe = meshctx.gather_data(flat_e, dp_axes)
        fg = meshctx.gather_data(flat_g, dp_axes)
        ds = d // dp
        dpi = 0
        for a in dp_axes:
            dpi = dpi * a.size + a.rank
        sl = slice(dpi * ds, (dpi + 1) * ds)

        def ffn2d(buf):
            dt = buf.dtype
            buf_l = buf[..., sl]
            hg = meshctx.all_reduce_data(
                torch.bmm(buf_l, p["wg"][:, sl].to(dt)), dp_axes)
            hi = meshctx.all_reduce_data(
                torch.bmm(buf_l, p["wi"][:, sl].to(dt)), dp_axes)
            y_part = torch.bmm(silu(hg) * hi, p["wo"][..., sl].to(dt))
            return meshctx.gather_data(y_part, dp_axes, dim=2)
    xs = meshctx.copy_to_model(xs, ax)
    y = _dispatch_compute_combine(xs, fe, meshctx.copy_to_model(fg, ax), k,
                                  C, p["wi"], p["wg"], p["wo"], e_off,
                                  expert_ffn=ffn2d)
    y = _combine(y, combine, ax, xt.dtype)
    if expert_2d:
        y = meshctx.data_block(y, dp_axes)
    if shared:
        y = y + mlp_apply(p["shared"], xt, cfg,
                          d_ff=shared_expert_width(cfg))
    return y.reshape(B, S, d), aux


def _moe_fused_ep(p: Params, cfg, xt: torch.Tensor, ax, dp_axes, B: int,
                  S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fully fused expert parallelism: routing, dispatch, the expert FFN,
    the shared experts (each rank its slice of their hidden width) and
    the aux loss's partial sums on each model rank, over the tokens of
    its data shard; one combine over "model" (psum, or under the bf16
    reduce-scatter the bf16 sum with its values, module docstring).  The routing runs on every model rank on the same
    rows, so only the gates enter the split compute (their partial
    cotangents summed over "model")."""
    T, d = xt.shape
    k, E = cfg.moe_top_k, cfg.moe_experts
    n_local = E // ax.size
    C = _capacity(max(1, T), k, E, cfg.moe_capacity_factor)
    combine = cfg.moe_combine
    if combine == "reduce_scatter" and T % ax.size:
        combine = "psum"   # decode batches too small to scatter
    fe, fg, (cnt, psum_probs) = _route_local(cfg, xt, p["router"]["w"])
    xs = meshctx.copy_to_model(xt, ax)
    y = _dispatch_compute_combine(xs, fe, meshctx.copy_to_model(fg, ax), k,
                                  C, p["wi"], p["wg"], p["wo"],
                                  ax.rank * n_local)
    shared = cfg.n_shared_experts and ("shared" in p)
    split_shared = shared and hidden_split(shared_expert_width(cfg),
                                           ax.size)
    if split_shared:
        y = y + _shared_partial(cfg, xs, p["shared"], ax)
    y = _combine(y, "reduce_scatter" if combine == "reduce_scatter"
                 else "psum", ax, xt.dtype)
    if shared and not split_shared:
        y = y + mlp_apply(p["shared"], xt, cfg,
                          d_ff=shared_expert_width(cfg))
    aux = _aux(cfg, cnt, psum_probs, dp_axes)
    return y.reshape(B, S, d), aux
