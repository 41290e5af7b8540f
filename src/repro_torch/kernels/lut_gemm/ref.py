"""Plain PyTorch versions of the LUT GEMM kernel.

The LUT decomposition is algebraically the plain integer GEMM over the
sign-extended weights, so the oracle IS the dense dot with the identical
epilogue (:func:`lut_gemm_ref`) — any divergence from the table path is a
kernel bug.  :func:`lut_gemm_table_ref` spells out the table algorithm the
CUDA kernel runs (subset-sum tables, bit-plane indices, gather and sum), so
the CPU tests can hold the decomposition itself against the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..vta_gemm.ref import vta_gemm_ref

EPILOGUES = ("none", "requant")


def lut_gemm_ref(a: torch.Tensor, w: torch.Tensor, *,
                 epilogue: str = "none", shift: int = 0) -> torch.Tensor:
    """C = epilogue(A @ W): a (..., M, K) int8, w (..., K, N) int8 holding
    sign-extended b-bit values.  "none" -> int32, "requant" -> int8."""
    if epilogue not in EPILOGUES:
        raise ValueError(epilogue)
    return vta_gemm_ref(a, w, epilogue=epilogue, shift=shift)


def lut_gemm_table_ref(a: torch.Tensor, w: torch.Tensor, *, bits: int,
                       group: int = 4, epilogue: str = "none",
                       shift: int = 0) -> torch.Tensor:
    """The T-MAC table algorithm in PyTorch (exact, int64 then wrapped to
    int32 like the kernel's uint32 sums).

    Per row and group of `group` K lanes: the table of all 2^group subset
    sums of the activations.  Per weight bit plane and group: the g-bit
    index of that plane's bits.  acc = sum over planes of coef_t * sum over
    groups of table[idx], with coef_t = 2^t and the MSB plane negative.
    K is zero-padded to a multiple of `group` (zero lanes add nothing)."""
    if epilogue not in EPILOGUES:
        raise ValueError(epilogue)
    K = a.shape[-1]
    pad = (-K) % group
    a64 = F.pad(a.to(torch.int64), (0, pad))
    w64 = F.pad(w.to(torch.int64), (0, 0, 0, pad))
    *lead, M, Kp = a64.shape
    N = w64.shape[-1]
    G, P = Kp // group, 1 << group
    dev = a.device
    pats = torch.arange(P, device=dev)
    lanes = torch.arange(group, device=dev)
    bitsel = (pats[:, None] >> lanes[None, :]) & 1                # (P, g)
    table = a64.reshape(*lead, M, G, group) @ bitsel.T            # (.., M, G, P)
    wu = (w64 & ((1 << bits) - 1)).reshape(*lead, G, group, N)
    lane_w = (1 << lanes)[:, None]                                # (g, 1)
    acc = torch.zeros((*lead, M, N), dtype=torch.int64, device=dev)
    for t in range(bits):
        idx = (((wu >> t) & 1) * lane_w).sum(-2)                  # (.., G, N)
        picked = torch.gather(
            table, -1, idx.unsqueeze(-3).expand(*lead, M, G, N))
        coef = -(1 << t) if t == bits - 1 else (1 << t)           # MSB = sign
        acc += coef * picked.sum(-2)
    acc = acc.to(torch.int32)
    if epilogue == "none":
        return acc
    return (acc >> min(int(shift), 31)).clamp(-128, 127).to(torch.int8)
