"""Plain PyTorch versions of the chunked gated-linear-attention scan, in
the layout of the reference's ``gla_chunk_pallas``: q, k (BH, nc, Q, N),
v (BH, nc, Q, P), la (BH, nc, Q) log-decay, h0 (BH, N, P) float32.

The recurrence, per batch·head row and step t over the nc * Q steps:
    h_t = exp(la_t) h_{t-1} + k_t v_tᵀ,    y_t = q_t · h_t
with h_{-1} = h0.  Two forms:
  * gla_chunk_ref  — the chunked algorithm (quadratic within a chunk of Q
    steps, a sequential scan of the states across chunks), float32 math;
  * gla_recurrence — the step-by-step recurrence above, an oracle
    independent of the chunking.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _f32(*xs: torch.Tensor):
    return [x.to(torch.float32) for x in xs]


def gla_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  la: torch.Tensor, h0: torch.Tensor,
                  y_dtype: Optional[torch.dtype] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same signature as ``gla_chunk_pallas``.  Returns y (BH, nc, Q, P) in
    `y_dtype` (default q's dtype) and the final h (BH, N, P) float32.

    Per chunk (L the within-chunk cumsum of la, L_tot its last entry):
        y = (q kᵀ ⊙ exp(L_i − L_j) ⊙ causal) v + (q ⊙ exp L) h
        h ← exp(L_tot) h + (k ⊙ exp(L_tot − L))ᵀ v
    The mask is applied before the exponential: above the diagonal
    L_i − L_j > 0 could overflow."""
    qf, kf, vf, laf = _f32(q, k, v, la)
    Q = q.shape[2]
    L = torch.cumsum(laf, dim=2)                         # (BH, nc, Q)
    Ltot = L[:, :, -1]                                   # (BH, nc)

    # intra-chunk: causal decay-weighted attention, every chunk at once
    scores = torch.einsum("bcqn,bckn->bcqk", qf, kf)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    decay = L[..., :, None] - L[..., None, :]            # L_i - L_j
    w = torch.exp(torch.where(causal, decay, torch.full_like(decay,
                                                             -torch.inf)))
    y = torch.einsum("bcqk,bckp->bcqp", scores * w, vf)

    # each chunk's own state: sum_j exp(L_tot - L_j) k_j v_jᵀ
    ks = kf * torch.exp(Ltot[..., None] - L)[..., None]
    state_c = torch.einsum("bcqn,bcqp->bcnp", ks, vf)    # (BH, nc, N, P)

    # sequential scan across chunks: h_c = exp(L_tot,c) h_{c-1} + state_c
    d = torch.exp(Ltot)                                  # (BH, nc)
    h = h0.to(torch.float32)
    h_in = torch.empty_like(state_c)
    for c in range(q.shape[1]):
        h_in[:, c] = h
        h = h * d[:, c, None, None] + state_c[:, c]

    # inter-chunk: the carried state's contribution
    qd = qf * torch.exp(L)[..., None]
    y = y + torch.einsum("bcqn,bcnp->bcqp", qd, h_in)
    return y.to(y_dtype or q.dtype), h


def gla_recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   la: torch.Tensor, h0: torch.Tensor,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step-by-step recurrence, in gla_chunk_ref's layout, computed in
    `dtype` (float32, or float64 for an oracle of the float32 versions):
    y (BH, nc, Q, P) and the final h (BH, N, P) in that dtype."""
    BH, nc, Q, N = q.shape
    P = v.shape[-1]
    qf, kf, vf, laf = (x.to(dtype).reshape(BH, nc * Q, -1)
                       for x in (q, k, v, la[..., None]))
    h = h0.to(dtype)
    ys = []
    for t in range(nc * Q):
        h = h * torch.exp(laf[:, t])[:, :, None] \
            + kf[:, t, :, None] * vf[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", qf[:, t], h))
    return torch.stack(ys, dim=1).reshape(BH, nc, Q, P), h
