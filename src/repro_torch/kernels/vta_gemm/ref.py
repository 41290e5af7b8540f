"""Plain PyTorch version of the VTA GEMM kernel (identical integer
semantics).  The CPU tests run it; on the card it is what the kernel is
held against."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

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


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """The per-tensor activation scale of max|x| = amax (a 0-d tensor in
    x's dtype, clamped at 1e-6): amax / 127 as an IEEE float32 division,
    rounded to x's dtype and widened to float32 (``quantize_activations``;
    the mesh path passes the global amax, ``models/layers.py``)."""
    return (amax.to(torch.float32)
            / torch.full((), 127.0, device=amax.device)) \
        .to(amax.dtype).to(torch.float32)


def quantize_activations(x2: torch.Tensor,
                         x_scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dynamic per-tensor int8 quantization of float
    activations x2 (M, K): (x_q int8, x_scale float32).  amax is taken and
    clamped in x's dtype; amax / 127 is an IEEE float32 division (a 0-d
    tensor divisor: on the card PyTorch would multiply by the reciprocal of
    a Python scalar), rounded to x's dtype and widened; x is divided by the
    scale in float32 (torch keeps a bfloat16 tensor over a 0-d float32
    tensor in bfloat16, JAX promotes it, so the cast is explicit), rounded
    half to even and clipped."""
    if x_scale is None:
        x_scale = activation_scale(x2.abs().amax().clamp_min(1e-6))
    x_q = torch.round(x2.to(torch.float32) / x_scale) \
        .clamp(-128, 127).to(torch.int8)
    return x_q, x_scale


def quantized_linear_ref(x: torch.Tensor, w_q: torch.Tensor,
                         w_scale: torch.Tensor,
                         x_scale: Optional[torch.Tensor] = None,
                         gemm: Callable = vta_gemm_ref) -> torch.Tensor:
    """The plain chain of quantized_linear: y = (x_q @ w_q) * (w_scale[n] *
    x_scale), in x's dtype, the GEMM through `gemm` (the plain GEMM, or the
    vta_gemm op on the CPU route)."""
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1])
    x_q, x_scale = quantize_activations(x2, x_scale)
    scale = w_scale.to(torch.float32) * x_scale
    y = gemm(x_q, w_q, scale=scale, epilogue="dequant")
    return y.reshape(*orig_shape[:-1], w_q.shape[1]).to(x.dtype)
