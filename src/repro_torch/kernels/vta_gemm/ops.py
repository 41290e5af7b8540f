"""Public op: quantized GEMM through the VTA datapath.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the CUDA kernel; any other device raises.  There is no fallback between
the two.  A leading tile axis batches peer tiles into one launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import EPILOGUES, OUT_DTYPES, vta_gemm_cuda
from .ref import vta_gemm_ref


def vta_gemm(a: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             scale: Optional[torch.Tensor] = None,
             *, epilogue: str = "none", shift: int = 0) -> torch.Tensor:
    """int8 x int8 -> int32 GEMM with the fused VTA epilogue.

    a: (M, K) or (T, M, K) int8;  w: (K, N) or (T, K, N) int8 — a
    transposed view of a contiguous (N, K) matrix is read in place;
    bias: (N,) int32;  scale: (N,) float32 (required for "dequant").
    epilogue: "none" -> int32, "requant" -> clip(acc >> shift) int8,
    "dequant" -> acc * scale float32.  M, N and K may be any sizes.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == "requant" and shift < 0:
        raise ValueError(f"requant shift must be >= 0, got {shift}")
    if epilogue == "dequant" and scale is None:
        raise ValueError("dequant needs scale")
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"vta_gemm takes int8 operands, got {a.dtype}, "
                        f"{w.dtype}")
    if a.dim() != w.dim() or a.dim() not in (2, 3) \
            or a.shape[-1] != w.shape[-2] \
            or (a.dim() == 3 and a.shape[0] != w.shape[0]):
        raise ValueError(f"vta_gemm shapes {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
    dev = a.device
    for t in (w, bias, scale):
        if t is not None and t.device != dev:
            raise ValueError("vta_gemm operands on different devices")
    if dev.type == "cpu":
        return vta_gemm_ref(a, w, bias, scale, epilogue=epilogue,
                            shift=shift)
    if dev.type != "cuda":
        raise ValueError(f"vta_gemm has no kernel for device {dev}")
    a3 = a if a.dim() == 3 else a[None]
    w3 = w if w.dim() == 3 else w[None]
    T, M, K = a3.shape
    N = w3.shape[-1]
    if T == 0 or M == 0 or N == 0:
        out = torch.empty((T, M, N), dtype=OUT_DTYPES[epilogue], device=dev)
        return out if a.dim() == 3 else out[0]
    out = vta_gemm_cuda(
        a3.contiguous(), w3.transpose(1, 2).contiguous(),
        bias.to(torch.int32).contiguous() if bias is not None else None,
        scale.to(torch.float32).contiguous() if scale is not None else None,
        epilogue, shift)
    vta_gemm.launches += 1
    key = (T, M, N, K, epilogue, shift, bias is not None)
    vta_gemm.shapes[key] = vta_gemm.shapes.get(key, 0) + 1
    return out if a.dim() == 3 else out[0]


#: kernel launches made by this op (plain-version calls do not count)
vta_gemm.launches = 0
#: (T, M, N, K, epilogue, shift, has_bias) -> launches at that shape
vta_gemm.shapes = {}


def quantized_linear(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor,
                     x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LM serving path: y = (x_q @ w_q) * (sx * sw[n]), in x's dtype.

    x: float activations, dynamically quantized to int8 per tensor;
    w_q: (K, N) int8 with per-channel scales w_scale (N,) float32.  A
    transposed view of a contiguous (N, K) matrix (what
    ``models.quantized.quantize_params`` stores) reaches the kernel with no
    copy.  The dtype steps are the reference's: amax is taken and divided
    by 127 in x's dtype, then cast to float32; x is divided by that scale
    in float32 (torch keeps a bfloat16 tensor over a 0-d float32 tensor in
    bfloat16, JAX promotes it, so the cast is explicit), rounded half to
    even and clipped.
    """
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1])
    if x_scale is None:
        amax = x2.abs().amax().clamp_min(1e-6)
        x_scale = (amax / 127.0).to(torch.float32)
    x_q = torch.round(x2.to(torch.float32) / x_scale) \
        .clamp(-128, 127).to(torch.int8)
    scale = w_scale.to(torch.float32) * x_scale
    y = vta_gemm(x_q, w_q, scale=scale, epilogue="dequant")
    return y.reshape(*orig_shape[:-1], w_q.shape[1]).to(x.dtype)
