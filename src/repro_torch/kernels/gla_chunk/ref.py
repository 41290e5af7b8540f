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


def gla_chunk_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      la: torch.Tensor, h0: Optional[torch.Tensor],
                      dy: torch.Tensor, dh: Optional[torch.Tensor], *,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``gla_chunk_ref`` for the output gradients dy (BH,
    nc, Q, P) and dh (BH, N, P) or None (zeros), written out (no
    autograd), in `dtype` (float32, or float64 for an oracle).  Returns
    (dq, dk, dv, dla, dh0) in that dtype, in the layout of the operands.

    With Λ the cumsum of la over the whole sequence, L its cumsum within a
    chunk, L_tot,c chunk c's last L, h_c the state entering chunk c and
    G_c its gradient (G_nc = dh):
        G_c  = exp(L_tot,c) G_{c+1} + Σ_i exp(L_i) q_i dy_iᵀ
        dq_i = Σ_{j≤i} (dy_i·v_j) e^{L_i−L_j} k_j + e^{L_i} h_c dy_i
        dk_j = Σ_{i≥j} (dy_i·v_j) e^{L_i−L_j} q_i + e^{L_tot−L_j} G_{c+1} v_j
        dv_j = Σ_{i≥j} (q_i·k_j) e^{L_i−L_j} dy_i
               + e^{L_tot−L_j} G_{c+1}ᵀ k_j
        dΛ_t = q_t·dq_t − k_t·dk_t (+ ⟨dh, h_final⟩ at the last step),
    dla the reverse cumsum of dΛ over the sequence, dh0 = G_0.  dla is
    summed chunk by chunk: for a step of chunk c, the later steps' dΛ in
    chunk c plus ⟨G_{c+1}, h_{c+1}⟩ (h_{c+1} the state leaving chunk c),
    which equals the rest of the sequence's sum; a sum carried along the
    whole sequence makes every step's error that of all later steps, and
    a weighted sum of dla (Mamba2's A_log gradient) about 10x worse.  The
    causal tile's share of dΛ_t is summed from small terms, as autograd of
    the forward sums it: Σ_j A_tj − Σ_i A_it, A_ij = (dy_i·v_j)(q_i·k_j)
    e^{L_i−L_j} (j ≤ i), not q_t·dq_t − k_t·dk_t's dot products of
    rounded sums (3x the error in that weighted sum).  The mask is applied
    before the exponential, as in the forward."""
    qf, kf, vf, laf, dyf = (x.to(dtype) for x in (q, k, v, la, dy))
    BH, nc, Q, N = q.shape
    P = v.shape[-1]
    L = torch.cumsum(laf, dim=2)                         # (BH, nc, Q)
    Ltot = L[:, :, -1]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    decay = L[..., :, None] - L[..., None, :]            # L_i - L_j
    w = torch.exp(torch.where(causal, decay, torch.full_like(decay,
                                                             -torch.inf)))
    eL = torch.exp(L)[..., None]                         # (BH, nc, Q, 1)
    eK = torch.exp(Ltot[..., None] - L)[..., None]
    d = torch.exp(Ltot)                                  # (BH, nc)

    # the states entering each chunk, and the final one
    state_c = torch.einsum("bcqn,bcqp->bcnp", kf * eK, vf)
    h = torch.zeros((BH, N, P), dtype=dtype, device=q.device) \
        if h0 is None else h0.to(dtype)
    h_in = torch.empty_like(state_c)
    for c in range(nc):
        h_in[:, c] = h
        h = h * d[:, c, None, None] + state_c[:, c]
    # the gradient of the state leaving each chunk, G_{c+1}, and G_0
    grad_c = torch.einsum("bcqn,bcqp->bcnp", qf * eL, dyf)
    g = torch.zeros((BH, N, P), dtype=dtype, device=q.device) \
        if dh is None else dh.to(dtype)
    g_out = torch.empty_like(grad_c)
    for c in reversed(range(nc)):
        g_out[:, c] = g
        g = g * d[:, c, None, None] + grad_c[:, c]

    S = torch.einsum("bcqn,bckn->bcqk", qf, kf)          # i rows, j columns
    dP = torch.einsum("bcqp,bckp->bcqk", dyf, vf)
    W, D = S * w, dP * w
    dq_in = eL * torch.einsum("bcqp,bcnp->bcqn", dyf, h_in)
    dk_in = eK * torch.einsum("bcqp,bcnp->bcqn", vf, g_out)
    dq = torch.einsum("bcqk,bckn->bcqn", D, kf) + dq_in
    dk = torch.einsum("bcqk,bcqn->bckn", D, qf) + dk_in
    dv = torch.einsum("bcqk,bcqp->bckp", W, dyf) \
        + eK * torch.einsum("bcqn,bcnp->bcqp", kf, g_out)
    # dΛ: the within-chunk part as A's row sum less its column sum, A_ij =
    # (dy_i·v_j)(q_i·k_j) e^{L_i−L_j}, the states' part as dot products;
    # dla chunk by chunk: Σ over the later steps of the chunk, plus
    # ⟨G_{c+1}, h_{c+1}⟩, which equals Σ over every later chunk of dΛ (plus
    # ⟨dh, h_final⟩) without carrying their rounding along the sequence
    A = dP * W
    dlam = A.sum(-1) - A.sum(-2) + (qf * dq_in).sum(-1) \
        - (kf * dk_in).sum(-1)                          # (BH, nc, Q)
    h_out = torch.cat([h_in[:, 1:], h[:, None]], dim=1)  # h_{c+1}
    tail = (g_out * h_out).sum(dim=(2, 3))               # (BH, nc)
    dla = torch.flip(torch.cumsum(torch.flip(dlam, (2,)), 2), (2,)) \
        + tail[..., None]
    return dq, dk, dv, dla, g
