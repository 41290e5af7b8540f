"""xLSTM blocks: mLSTM (matrix memory, parallelizable — lowered onto the
chunked GLA core with a denominator channel) and sLSTM (scalar memory,
strictly recurrent — a loop over time): the port of the reference's
``models/xlstm.py``.

mLSTM recurrence (per head):
    C_t = f_t C_{t-1} + i_t v_t k_tᵀ          (matrix memory)
    n_t = f_t n_{t-1} + i_t k_t                (normalizer)
    h_t = (C_t q_t) / max(|n_t · q_t|, 1)
Implemented by appending a constant-1 channel to v so that the GLA state
carries (C | n) jointly — one scan, exact semantics.  Training and the
prefill run ``ssm.chunked_gla`` at chunk 512 (the ``gla_chunk`` op: its
CUDA kernel on the card, its plain version on the CPU; in training its
gradient is the op's backward kernel); the decode takes one
``ssm.gla_step`` (plain PyTorch, as in the reference).  The sLSTM has no
kernel in the reference either: a Python loop over time, a handful of
PyTorch operations a step, whose gradient in training is autograd's
through that loop.

The math keeps the reference's dtypes: ``v * i`` is float32 (a bf16 v
times the float32 gate promotes), the denominator channel is ``i``
rounded to v's dtype first, and both caches are float32 whatever dtype
the model has.  The sLSTM normalizer state ``n`` starts at ones.  Caches
are updated in place; each function returns the cache dict so the call
sites read as the reference's.  The train forms (``mlstm_train``,
``slstm_train``) take no cache: the mLSTM scans from a zero state, the
sLSTM runs from ``init_slstm_cache``'s state.

The 7:1 mLSTM:sLSTM interleave of xlstm-1.3b is expressed through
ModelConfig.block_pattern (slstm_every=8).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .layers import linear_apply, linear_init, norm_apply, norm_init, \
    silu, torch_dtype
from .ssm import chunked_gla, gla_step

Params = Dict[str, Any]

#: the mLSTM prefill's scan chunk (the reference's): a prompt longer than
#: 512 tokens must be a multiple of 512
MLSTM_CHUNK = 512


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), device=x.device))


# ----------------------------------------------------------------------
# mLSTM block
# ----------------------------------------------------------------------
def _qk_dim(cfg) -> int:
    """mLSTM uses a narrower q/k dim than the value dim (official xLSTM
    does the same): the matrix memory is (N_qk x P_v) per head."""
    dh_v = (2 * cfg.d_model) // cfg.n_heads
    return max(64, dh_v // 4)


def mlstm_init(gen: torch.Generator, cfg, device: torch.device,
               lead: Tuple[int, ...] = ()) -> Params:
    """The reference's parameters and distributions (not its numbers)."""
    d, H, nqk = cfg.d_model, cfg.n_heads, _qk_dim(cfg)
    dt = torch_dtype(cfg)
    return {
        "up_x": linear_init(gen, d, 2 * d, dt, device, lead),
        "up_z": linear_init(gen, d, 2 * d, dt, device, lead),
        "wq": linear_init(gen, 2 * d, H * nqk, dt, device, lead),
        "wk": linear_init(gen, 2 * d, H * nqk, dt, device, lead),
        "wv": linear_init(gen, 2 * d, 2 * d, dt, device, lead),
        # input + forget gates
        "w_if": linear_init(gen, 2 * d, 2 * H, dt, device, lead),
        "down": linear_init(gen, 2 * d, d, dt, device, lead),
        "norm": norm_init(cfg, 2 * d, device, lead),
    }


def _mlstm_qkvg(p: Params, cfg, xu: torch.Tensor):
    B, S, d2 = xu.shape
    H = cfg.n_heads
    dh = d2 // H
    nqk = _qk_dim(cfg)
    q = linear_apply(p["wq"], xu, cfg).reshape(B, S, H, nqk)
    k = linear_apply(p["wk"], xu, cfg).reshape(B, S, H, nqk) / math.sqrt(nqk)
    v = linear_apply(p["wv"], xu, cfg).reshape(B, S, H, dh)
    gates = linear_apply(p["w_if"], xu, cfg).to(torch.float32)
    i_gate = torch.exp(-_softplus(-gates[..., :H]))       # sigmoid (B,S,H)
    log_f = -_softplus(-gates[..., H:])                   # log sigmoid
    return q, k, v, i_gate, log_f


def _with_denominator(v: torch.Tensor, i_gate: torch.Tensor) -> torch.Tensor:
    """v' = [i v | i]: float32 (v * i promotes), the last channel i
    rounded to v's dtype first, as the reference concatenates it."""
    return torch.cat([v * i_gate[..., None],
                      i_gate[..., None].to(v.dtype).to(torch.float32)],
                     dim=-1)


def _mlstm_out(p: Params, cfg, y: torch.Tensor, den: torch.Tensor,
               z: torch.Tensor, B: int, S: int) -> torch.Tensor:
    y = y / torch.clamp(torch.abs(den), min=1.0)          # normalizer
    y = y.reshape(B, S, 2 * cfg.d_model).to(z.dtype)
    y = norm_apply(cfg, p["norm"], y) * silu(z)
    return linear_apply(p["down"], y, cfg)


def mlstm_train(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); the chunked scan at chunk 512 from a zero state (S up
    to 512, or a multiple of it), no cache."""
    B, S, _ = x.shape
    xu = linear_apply(p["up_x"], x, cfg)
    z = linear_apply(p["up_z"], x, cfg)
    q, k, v, i_gate, log_f = _mlstm_qkvg(p, cfg, xu)
    y_all, _ = chunked_gla(q, k, _with_denominator(v, i_gate), log_f,
                           chunk=MLSTM_CHUNK)
    y, den = y_all[..., :-1], y_all[..., -1:]
    return _mlstm_out(p, cfg, y, den, z, B, S)


def init_mlstm_cache(cfg, batch: int, device: torch.device,
                     lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """The (C | n) state per head, float32 zeros."""
    H = cfg.n_heads
    dh = (2 * cfg.d_model) // H
    return {"h": torch.zeros(lead + (batch, H, _qk_dim(cfg), dh + 1),
                             dtype=torch.float32, device=device)}


def mlstm_prefill(p: Params, cfg, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) from the cache's state; the chunked scan at chunk
    512 (S up to 512, or a multiple of it).  The cache is updated in
    place."""
    B, S, _ = x.shape
    xu = linear_apply(p["up_x"], x, cfg)
    z = linear_apply(p["up_z"], x, cfg)
    q, k, v, i_gate, log_f = _mlstm_qkvg(p, cfg, xu)
    y_all, h = chunked_gla(q, k, _with_denominator(v, i_gate), log_f,
                           chunk=MLSTM_CHUNK, h0=cache["h"])
    cache["h"].copy_(h)
    y, den = y_all[..., :-1], y_all[..., -1:]
    return _mlstm_out(p, cfg, y, den, z, B, S), cache


def mlstm_decode(p: Params, cfg, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d); one step of the recurrence.  The cache is updated in
    place."""
    B = x.shape[0]
    xu = linear_apply(p["up_x"], x, cfg)
    z = linear_apply(p["up_z"], x, cfg)
    q, k, v, i_gate, log_f = _mlstm_qkvg(p, cfg, xu)
    vi = _with_denominator(v, i_gate)
    h, y_all = gla_step(cache["h"], q[:, 0], k[:, 0], vi[:, 0],
                        torch.exp(log_f[:, 0]))
    cache["h"].copy_(h)
    y, den = y_all[:, None, :, :-1], y_all[:, None, :, -1:]
    return _mlstm_out(p, cfg, y, den, z, B, 1), cache


# ----------------------------------------------------------------------
# sLSTM block (strictly recurrent)
# ----------------------------------------------------------------------
def slstm_init(gen: torch.Generator, cfg, device: torch.device,
               lead: Tuple[int, ...] = ()) -> Params:
    """The reference's parameters and distributions; the recurrent
    weight ``r`` is float32 whatever the model's dtype."""
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    dt = torch_dtype(cfg)
    r = torch.randn(lead + (H, dh, 4 * dh), generator=gen, device=device,
                    dtype=torch.float32) * (0.5 / math.sqrt(dh))
    return {
        "w_in": linear_init(gen, d, 4 * d, dt, device, lead),  # z i f o
        "r": r,
        "down": linear_init(gen, d, d, dt, device, lead),
        "norm": norm_init(cfg, d, device, lead),
    }


def init_slstm_cache(cfg, batch: int, device: torch.device,
                     lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """c and h float32 zeros; the normalizer n float32 ones."""
    shape = lead + (batch, cfg.d_model)
    return {"c": torch.zeros(shape, dtype=torch.float32, device=device),
            "n": torch.ones(shape, dtype=torch.float32, device=device),
            "h": torch.zeros(shape, dtype=torch.float32, device=device)}


def _slstm_cell(cfg, r: torch.Tensor, pre: torch.Tensor,
                state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """pre: (B, 4d) input preactivations; recurrent contribution from h.
    Returns the new state (new tensors)."""
    B = pre.shape[0]
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    c, n, h = state["c"], state["n"], state["h"]
    hr = torch.einsum("bhx,hxy->bhy", h.reshape(B, H, dh), r) \
        .reshape(B, 4 * d)
    z, i, f, o = torch.chunk(pre.to(torch.float32) + hr, 4, dim=-1)
    z = torch.tanh(z)
    i = torch.exp(torch.clamp(i, max=10.0))  # exponential input gate
    f = torch.exp(-_softplus(-f))            # sigmoid forget
    o = torch.exp(-_softplus(-o))
    c = f * c + i * z
    n = f * n + i
    h = o * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h}


def _store(cache: Dict[str, torch.Tensor],
           state: Dict[str, torch.Tensor]) -> None:
    for k in ("c", "n", "h"):
        cache[k].copy_(state[k])


def slstm_prefill(p: Params, cfg, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d); the cell once per step, from the cache's state.  The
    cache is updated in place."""
    pre = linear_apply(p["w_in"], x, cfg)                       # (B, S, 4d)
    state = dict(cache)
    hs = []
    for t in range(x.shape[1]):
        state = _slstm_cell(cfg, p["r"], pre[:, t], state)
        hs.append(state["h"])
    _store(cache, state)
    y = torch.stack(hs, dim=1).to(x.dtype)                 # (B, S, d)
    y = norm_apply(cfg, p["norm"], y)
    return linear_apply(p["down"], y, cfg), cache


def slstm_train(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); the cell once per step from ``init_slstm_cache``'s
    state, no cache (its gradient is autograd's through the loop)."""
    pre = linear_apply(p["w_in"], x, cfg)                       # (B, S, 4d)
    state = init_slstm_cache(cfg, x.shape[0], x.device)
    hs = []
    for t in range(x.shape[1]):
        state = _slstm_cell(cfg, p["r"], pre[:, t], state)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)                 # (B, S, d)
    y = norm_apply(cfg, p["norm"], y)
    return linear_apply(p["down"], y, cfg)


def slstm_decode(p: Params, cfg, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d); one cell step.  The cache is updated in place."""
    pre = linear_apply(p["w_in"], x, cfg)[:, 0]
    state = _slstm_cell(cfg, p["r"], pre, cache)
    _store(cache, state)
    y = state["h"][:, None].to(x.dtype)
    y = norm_apply(cfg, p["norm"], y)
    return linear_apply(p["down"], y, cfg), cache
