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
                       shift: int = 0, parts: int = 1) -> torch.Tensor:
    """The CUDA kernel's table arithmetic in PyTorch, word for word.

    Per row pass of mt rows (the kernel's instance, ``lut_plan``) and per
    K chunk of 512 lanes, the subset-sum tables of every group, as 32-bit
    words that hold two rows' entries as lo + 65536 hi (mod 2^32) from two
    rows up, stored at the kernel's layout (``table_word``) and gathered
    back through it by each weight bit plane's g-bit index.  Per 16-lane
    weight vector the packed lookups are summed mod 2^32 with the
    coefficients 2^t (the MSB plane negative), then split into the two
    rows' sums (lo is the sign-extended low half, hi = (word - lo) >> 16)
    and added into uint32 row sums.  K is split into `parts` ranges of
    whole vectors, each summed alone and the partial sums then added, as
    the kernel's split of K adds its blocks' partials.  K is zero-padded
    to a multiple of 16 (zero lanes add nothing)."""
    from .kernel import KC, ROW_INSTANCES, table_layout, table_word
    if epilogue not in EPILOGUES:
        raise ValueError(epilogue)
    K = a.shape[-1]
    pad = (-K) % 16
    a64 = F.pad(a.to(torch.int64), (0, pad))
    w64 = F.pad(w.to(torch.int64), (0, 0, 0, pad))
    *lead, M, Kp = a64.shape
    N = w64.shape[-1]
    inst = ROW_INSTANCES[group]
    mt = next((m for m in inst if m >= M), inst[-1])
    L = table_layout(group, mt)
    G, P, GPV, RP, WPP = group, L["P"], L["GPV"], L["RP"], L["WPP"]
    V = Kp // 16                                   # weight vectors
    dev = a.device
    mask32 = (1 << 32) - 1
    lanes = torch.arange(G, device=dev)
    bitsel = (torch.arange(P, device=dev)[:, None] >> lanes) & 1  # (P, g)
    # per plane: the g-bit index of every (group, column)
    wu = (w64 & ((1 << bits) - 1)).reshape(*lead, Kp // G, G, N)
    idx = [(((wu >> t) & 1) << lanes[:, None]).sum(-2) for t in range(bits)]
    coef = [-(1 << t) if t == bits - 1 else (1 << t) for t in range(bits)]
    nch = -(-V // 32)                              # K chunks
    ngrp = nch * (KC // G)
    idx = [F.pad(i, (0, 0, 0, ngrp - i.shape[-2])).reshape(
        *lead, nch, 32, GPV, 1, N) for i in idx]
    # the kernel-layout word of (vector, gsub, row word, pattern) in a chunk
    vv = torch.arange(32, device=dev)[:, None, None, None]
    gs = torch.arange(GPV, device=dev)[:, None, None]
    wi = torch.arange(WPP, device=dev)[:, None]
    slot = table_word(G, mt, vv, gs, wi, torch.arange(P, device=dev))
    nd = len(lead)
    acc = torch.zeros((*lead, M, N), dtype=torch.int64, device=dev)
    bounds = torch.linspace(0, V, parts + 1).round().long().tolist()
    for m0 in range(0, M, mt):
        rows = F.pad(a64[..., m0:m0 + mt, :], (0, 0, 0, mt - min(mt, M - m0)))
        # (.., mt, groups, P)
        table = rows.reshape(*lead, mt, Kp // G, G) @ bitsel.T
        if RP == 2:
            table = table[..., 0::2, :, :] + 65536 * table[..., 1::2, :, :]
        words = F.pad(table & mask32, (0, 0, 0, ngrp - Kp // G))
        # each chunk's table, stored at the kernel's layout
        src = words.reshape(*lead, WPP, nch, 32, GPV, P).permute(
            *range(nd), nd + 1, nd + 2, nd + 3, nd, nd + 4)
        flat = torch.zeros((*lead, nch, L["WORDS"]), dtype=torch.int64,
                           device=dev)
        flat[..., slot.reshape(-1)] = src.reshape(*lead, nch, -1)
        # the lookups of each (vector, group, plane, row word, column)
        packed = torch.zeros((*lead, nch, 32, WPP, N), dtype=torch.int64,
                             device=dev)
        for t in range(bits):
            # (.., nch, 32, GPV, WPP, N)
            at = table_word(G, mt, vv, gs, wi, idx[t])
            got = torch.gather(flat, -1, at.reshape(*lead, nch, -1))
            packed += coef[t] * got.reshape(at.shape).sum(-3)
        packed = (packed & mask32).reshape(*lead, nch * 32, WPP, N)[..., :V,
                                                                    :, :]
        if RP == 2:                                # split the row pairs
            lo = ((packed & 0xFFFF) ^ 0x8000) - 0x8000
            hi = (packed - lo) & mask32
            hi = ((hi ^ (1 << 31)) - (1 << 31)) >> 16
            vec = torch.stack([lo, hi], -2).reshape(*lead, V, mt, N)
        else:
            vec = packed
        sums = torch.zeros((*lead, mt, N), dtype=torch.int64, device=dev)
        for lo_v, hi_v in zip(bounds[:-1], bounds[1:]):
            sums = (sums + (vec[..., lo_v:hi_v, :, :].sum(-3) & mask32)) \
                & mask32
        n = min(mt, M - m0)
        acc[..., m0:m0 + n, :] = sums[..., :n, :]
    acc = ((acc & mask32) ^ (1 << 31)) - (1 << 31)  # uint32 -> int32
    acc = acc.to(torch.int32)
    if epilogue == "none":
        return acc
    return (acc >> min(int(shift), 31)).clamp(-128, 127).to(torch.int8)
