"""Plain PyTorch version of the VTA GEMM kernel (identical integer
semantics).  The CPU tests run it; on the card it is what the kernel is
held against."""
from __future__ import annotations

from typing import Optional

import torch


def vta_gemm_ref(a: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 *, epilogue: str = "none", shift: int = 0) -> torch.Tensor:
    """C = epilogue(A @ W + bias): a (..., M, K) int8, w (..., K, N) int8,
    bias (N,) int32, scale (N,) float32.

    The int32 accumulator: on the CPU ``torch.matmul`` of int32 operands;
    on the card (which has no int32 matmul) a float64 product cast back,
    exact while |acc| < 2^53 (int8 operands reach that only past K = 2^39).
    """
    if a.device.type == "cpu":
        acc = torch.matmul(a.to(torch.int32), w.to(torch.int32))
    else:
        acc = torch.matmul(a.to(torch.float64),
                           w.to(torch.float64)).to(torch.int32)
    if bias is not None:
        # wraps like the reference's int32 add
        acc = (acc.to(torch.int64) + bias.to(torch.int64)).to(torch.int32)
    if epilogue == "none":
        return acc
    if epilogue == "requant":
        # an int32 shifted right by 31 is already all sign bits: shifts of
        # 32 or more give the same sign fill as the reference's
        q = acc >> min(int(shift), 31)
        return q.clamp(-128, 127).to(torch.int8)
    if epilogue == "dequant":
        return acc.to(torch.float32) * scale.to(torch.float32)
    raise ValueError(epilogue)
