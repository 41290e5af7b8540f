"""The ``flash_attention`` op: its work from its shapes key, the kernels it
launches, and how many a call launches.

A shapes key is the op's counter key, ``(B, S, Sk, HQ, KH, D, causal,
dtype)``; dtype "bfloat16/float32" is a bfloat16 query over float32 K/V,
run in float32.  The work is what the arguments define, whatever kernel
runs it: each input read once and each output written once; the forward
2 products of 2 S Sk D FLOPs a head (q kᵀ, then P v), the backward 5 (q kᵀ
again, since P is not an argument, dO vᵀ, Pᵀ dO, dS k, dSᵀ q); halved
when causal.  The forward's optional row log-sum-exp is not counted; the
backward reads it.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .peaks import ELEMENT_BYTES, HBM_BYTES, flops_peak

OP = "flash_attention"

#: every kernel the op launches on the card -> "fwd" or "bwd"
KERNELS = {
    "flash_wgmma_kernel": "fwd",
    "flash_tf32x3_kernel": "fwd",
    "flash_wide_fwd_wgmma_kernel": "fwd",
    "flash_wide_fwd_tf32_kernel": "fwd",
    "flash_bwd_delta_kernel": "bwd",
    "flash_bwd_dkdv_wgmma_kernel": "bwd",
    "flash_bwd_dq_wgmma_kernel": "bwd",
    "flash_bwd_dkdv_kernel": "bwd",
    "flash_bwd_dq_kernel": "bwd",
    "flash_wide_delta_kernel": "bwd",
    "flash_wide_dq_wgmma_kernel": "bwd",
    "flash_wide_dkdv_wgmma_kernel": "bwd",
    "flash_wide_dq_tf32_kernel": "bwd",
    "flash_wide_dkdv_tf32_kernel": "bwd",
}

#: head dims up to this run the one-launch kernels counted below; wider
#: ones the wide kernels, whose launches vary with D and are not counted
MAX_D = 128


def counters() -> Dict[str, Dict[tuple, int]]:
    """The op's launch counters now: {"fwd": shapes, "bwd": bwd_shapes}."""
    from repro_torch.kernels.flash_attention import flash_attention as op
    return {"fwd": dict(op.shapes), "bwd": dict(op.bwd_shapes)}


def _dtypes(key: tuple) -> Tuple[str, str]:
    """(q and output dtype, K/V dtype)."""
    parts = key[7].split("/")
    return parts[0], parts[-1]


def work(key: tuple, phase: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call at `key`, "fwd" or "bwd"."""
    B, S, Sk, HQ, KH, D, causal, _ = key
    qd, kvd = _dtypes(key)
    qe, ke = ELEMENT_BYTES[qd], ELEMENT_BYTES[kvd]
    half = 2 if causal else 1
    q_bytes, kv_bytes = B * S * HQ * D * qe, B * Sk * KH * D * ke
    if phase == "fwd":
        return (4 * B * HQ * S * Sk * D / half,
                2 * q_bytes + 2 * kv_bytes)
    # read q, k, v, o, dO and L; write dq, dk, dv
    return (10 * B * HQ * S * Sk * D / half,
            4 * q_bytes + 4 * kv_bytes + B * HQ * S * 4)


def least_seconds(key: tuple, phase: str) -> float:
    """The least time of one call: the larger of its FLOPs at the
    tensor-core peak of its operands' dtype and its bytes at the memory
    rate."""
    flops, nbytes = work(key, phase)
    kvd = _dtypes(key)[1]
    return max(flops / flops_peak(kvd), nbytes / HBM_BYTES)


def expected_launches(fwd: Dict[tuple, int],
                      bwd: Dict[tuple, int]) -> Dict[str, int]:
    """{kernel: launches} that the counted calls made, for the kernels
    whose count per call is fixed (head dims up to MAX_D)."""
    out: Dict[str, int] = {}

    def add(name: str, n: int) -> None:
        out[name] = out.get(name, 0) + n
    for key, n in fwd.items():
        if key[5] <= MAX_D:
            add("flash_wgmma_kernel" if _dtypes(key)[1] == "bfloat16"
                else "flash_tf32x3_kernel", n)
    for key, n in bwd.items():
        if key[5] <= MAX_D:
            tail = "_wgmma_kernel" if key[7] == "bfloat16" else "_kernel"
            add("flash_bwd_delta_kernel", n)
            add("flash_bwd_dkdv" + tail, n)
            add("flash_bwd_dq" + tail, n)
    return out
