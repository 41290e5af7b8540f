"""The ``gla_chunk`` op (the chunked scan of Mamba2 and the mLSTM): its
work from its shapes key, the kernels it launches, and how many a call
launches.

A shapes key is the op's counter key, ``(B, S, H, N, P, Q, q dtype,
broadcast)``: Q the chunk the caller passes, broadcast True where q and
k are one row for every head (Mamba2's C and B).  The work is counted at
that chunk, whatever tile a kernel uses, so the count is the same
whatever implements the op; a product that does not depend on the head
(q kᵀ of a broadcast q and k) is counted once.  Per chunk of Q rows:

- forward: q kᵀ 2Q²N, its masked scores times v 2Q²P, the chunk's state
  kᵀ v 2QNP and q times the carried state 2QNP;
- backward: q kᵀ again and the two score gradients' products with k and
  q, 6Q²N; the two products with v and dY, 4Q²P; the states again, their
  gradient and the four products that take them, 10QNP.

``chip_smoke.py:gla_bound_ms`` and ``gla_bwd_bound_ms`` count at the
kernels' own tiles (the forward's ``gla_plan`` tile, the backward's 64
rows) and every product per head; these copies count at the caller's
chunk and the shared product once.  Bytes: q and k (once where
broadcast), v, the log decay, and y (float32: every caller in the port
asks for it) and the final state; the backward reads q, k, v, the decay
and dY and writes dq, dk (in q's dtype), dv, the decay's gradient and
the initial state's (float32).
"""
from __future__ import annotations

from typing import Dict, Tuple

from .peaks import ELEMENT_BYTES, HBM_BYTES, flops_peak

OP = "gla_chunk"

#: every kernel the op launches on the card -> "fwd" or "bwd"
KERNELS = {
    "gla_kernel": "fwd",
    "gla_bwd_state_kernel": "bwd",
    "gla_bwd_carry_kernel": "bwd",
    "gla_bwd_tile_kernel": "bwd",
    "gla_bwd_dla_kernel": "bwd",
    "gla_bwd_head_sum_kernel": "bwd",
}


def counters() -> Dict[str, Dict[tuple, int]]:
    """The op's launch counters now: {"fwd": shapes, "bwd": bwd_shapes}."""
    from repro_torch.kernels.gla_chunk import gla_chunk as op
    return {"fwd": dict(op.shapes), "bwd": dict(op.bwd_shapes)}


def work(key: tuple, phase: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call at `key`, "fwd" or "bwd"."""
    B, S, H, N, P, Q, qd, broadcast = key
    hq = 1 if broadcast else H
    q = min(Q, S)
    chunks = B * (S // q)
    qe = ELEMENT_BYTES[qd]
    qk_bytes = 2 * B * S * hq * N * qe
    v_bytes, la_bytes = B * S * H * P * 4, B * S * H * 4
    state_bytes = B * H * N * P * 4
    if phase == "fwd":
        flops = chunks * (hq * 2 * q * q * N
                          + H * (2 * q * q * P + 4 * q * N * P))
        return flops, qk_bytes + v_bytes + la_bytes + v_bytes + state_bytes
    flops = chunks * (hq * 6 * q * q * N
                      + H * (4 * q * q * P + 10 * q * N * P))
    return flops, (2 * qk_bytes + 3 * v_bytes + 2 * la_bytes
                   + state_bytes)


def least_seconds(key: tuple, phase: str) -> float:
    """The larger of the FLOPs at the tensor-core peak of q's dtype and
    the bytes at the memory rate."""
    flops, nbytes = work(key, phase)
    return max(flops / flops_peak(key[6]), nbytes / HBM_BYTES)


def expected_launches(fwd: Dict[tuple, int],
                      bwd: Dict[tuple, int]) -> Dict[str, int]:
    """{kernel: launches} that the counted calls made: one forward kernel
    a call; four backward kernels a call, and the head sum where q and k
    are one row for every head."""
    out = {"gla_kernel": sum(fwd.values())}
    n = sum(bwd.values())
    for name in ("gla_bwd_state_kernel", "gla_bwd_carry_kernel",
                 "gla_bwd_tile_kernel", "gla_bwd_dla_kernel"):
        out[name] = n
    out["gla_bwd_head_sum_kernel"] = sum(c for k, c in bwd.items() if k[7])
    return {k: v for k, v in out.items() if v}
