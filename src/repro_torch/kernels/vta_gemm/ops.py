"""Public op: quantized GEMM through the VTA datapath.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the CUDA kernel; a ``meta`` tensor (the dry run) takes the card's route
with nothing launched (``kernels/_meta.py``: the card's allocations, 2 M
N K FLOPs a tile); any other device raises.  There is no fallback
between the two.  A leading tile axis batches peer tiles into one launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _meta
from .._grad import refuse_grad
from .kernel import (EPILOGUES, OUT_DTYPES, X_DTYPES, quantized_linear_cuda,
                     vta_gemm_cuda)
from .ref import quantized_linear_ref, vta_gemm_ref


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
    refuse_grad("vta_gemm", (a, w, bias, scale))
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
    if dev.type not in ("cuda", "meta"):
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
    if dev.type == "meta":
        _meta.record("vta_gemm", 2 * T * M * N * K, a, w, bias, scale, out)
        return out if a.dim() == 3 else out[0]
    _count((T, M, N, K, epilogue, shift, bias is not None))
    return out if a.dim() == 3 else out[0]


#: kernel launches made by this op (plain-version calls do not count)
vta_gemm.launches = 0
#: (T, M, N, K, epilogue, shift, has_bias) -> launches at that shape
vta_gemm.shapes = {}
#: the op itself: the counts stay on it whatever function a caller swaps
#: in at this module's name `vta_gemm`
_VTA_GEMM = vta_gemm


def _count(key) -> None:
    _VTA_GEMM.launches += 1
    _VTA_GEMM.shapes[key] = _VTA_GEMM.shapes.get(key, 0) + 1


def quantized_linear(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor,
                     x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LM serving path: y = (x_q @ w_q) * (sx * sw[n]), in x's dtype.

    x: float activations, dynamically quantized to int8 per tensor
    (``ref.quantize_activations``: the reference's dtype steps); w_q: (K,
    N) int8 with per-channel scales w_scale (N,) float32.  A transposed
    view of a contiguous (N, K) matrix (what
    ``models.quantized.quantize_params`` stores) reaches the kernel with no
    copy.  A CPU tensor runs the plain chain through :func:`vta_gemm`; a
    CUDA tensor (float32 or bfloat16 x) runs the quantization, GEMM and
    dequantization in the vta_gemm kernels, one launch (two above 16
    rows), bitwise equal to ``ref.quantized_linear_ref``.
    """
    refuse_grad("quantized_linear", (x, w_q, w_scale, x_scale))
    if x.dim() < 1 or w_q.dim() != 2 or x.shape[-1] != w_q.shape[0] \
            or w_scale.shape != (w_q.shape[1],):
        raise ValueError(f"quantized_linear shapes {tuple(x.shape)} @ "
                         f"{tuple(w_q.shape)}, w_scale "
                         f"{tuple(w_scale.shape)}")
    dev = x.device
    if dev.type == "cpu":
        return quantized_linear_ref(x, w_q, w_scale, x_scale, gemm=vta_gemm)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"quantized_linear has no kernel for device {dev}")
    if x.dtype not in X_DTYPES or w_q.dtype != torch.int8:
        raise TypeError(f"quantized_linear on the card takes float32 or "
                        f"bfloat16 x and int8 w_q, got {x.dtype}, "
                        f"{w_q.dtype}")
    if w_q.device != dev or w_scale.device != dev or (
            x_scale is not None and x_scale.device != dev):
        raise ValueError("quantized_linear operands on different devices")
    orig_shape = x.shape
    K, N = w_q.shape
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if M == 0 or N == 0:
        return torch.empty((*orig_shape[:-1], N), dtype=x.dtype, device=dev)
    xs = None if x_scale is None \
        else x_scale.to(torch.float32).reshape(1).contiguous()
    y = quantized_linear_cuda(x2, w_q.t().contiguous(),
                              w_scale.to(torch.float32).contiguous(), xs)
    if dev.type == "meta":
        _meta.record("quantized_linear", 2 * M * N * K, x, w_q, w_scale, y)
        return y.reshape(*orig_shape[:-1], N)
    _count((1, M, N, K, "dequant", 0, False))
    qkey = (M, N, K, str(x.dtype).split(".")[-1])
    quantized_linear.shapes[qkey] = quantized_linear.shapes.get(qkey, 0) + 1
    return y.reshape(*orig_shape[:-1], N)


#: (M, N, K, x dtype) -> fused launches at that shape (each is also one of
#: vta_gemm.launches, under vta_gemm's own key)
quantized_linear.shapes = {}
