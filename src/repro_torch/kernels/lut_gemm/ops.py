"""Public op: sub-byte weight GEMM by activation-table lookup (T-MAC).

A CPU tensor takes the plain version (``ref.py``: the dense integer GEMM,
which the table algorithm equals bit for bit); a CUDA tensor launches the
CUDA kernel; any other device raises.  There is no fallback between the
two.  The reference pads K to a multiple of the group and N to its column
block; zero weight values contribute nothing on any bit plane and zero
activation lanes add nothing to any subset sum, so the padding is exact,
and the CUDA kernel masks the same edges in place instead of copying.
"""
from __future__ import annotations

import torch

from .._grad import refuse_grad
from .kernel import EPILOGUES, GROUPS, OUT_DTYPES, lut_gemm_cuda
from .ref import lut_gemm_ref


def lut_gemm(a: torch.Tensor, w: torch.Tensor, *, bits: int, group: int = 4,
             epilogue: str = "none", shift: int = 0) -> torch.Tensor:
    """int8 x int{bits} -> int32 GEMM (optionally fused requant -> int8).

    a: (M, K) or (T, M, K) int8;  w: (K, N) or (T, K, N) int8 holding
    sign-extended b-bit values (a transposed view of a contiguous (N, K)
    matrix is read in place).  Bit-identical to ``vta_gemm(a, w, ...)`` —
    the dense path is the differential reference.  Weights outside the
    b-bit range are not checked: the kernel reads only their low b bits.
    """
    refuse_grad("lut_gemm", (a, w))
    if bits not in (1, 2, 4):
        raise ValueError(f"lut_gemm: bits must be 1, 2 or 4, got {bits}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == "requant" and shift < 0:
        raise ValueError(f"requant shift must be >= 0, got {shift}")
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"lut_gemm takes int8 operands, got {a.dtype}, "
                        f"{w.dtype}")
    if a.dim() != w.dim() or a.dim() not in (2, 3) \
            or a.shape[-1] != w.shape[-2] \
            or (a.dim() == 3 and a.shape[0] != w.shape[0]):
        raise ValueError(f"lut_gemm shapes {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
    dev = a.device
    if w.device != dev:
        raise ValueError("lut_gemm operands on different devices")
    if dev.type == "cpu":
        return lut_gemm_ref(a, w, epilogue=epilogue, shift=shift)
    if dev.type != "cuda":
        raise ValueError(f"lut_gemm has no kernel for device {dev}")
    if group not in GROUPS:
        raise ValueError(f"the lut_gemm kernel takes group in {GROUPS}, "
                         f"got {group}")
    a3 = a if a.dim() == 3 else a[None]
    w3 = w if w.dim() == 3 else w[None]
    T, M, K = a3.shape
    N = w3.shape[-1]
    if T == 0 or M == 0 or N == 0:
        out = torch.empty((T, M, N), dtype=OUT_DTYPES[epilogue], device=dev)
        return out if a.dim() == 3 else out[0]
    out = lut_gemm_cuda(a3.contiguous(), w3.transpose(1, 2).contiguous(),
                        bits=bits, group=group, epilogue=epilogue,
                        shift=shift)
    lut_gemm.launches += 1
    key = (T, M, N, K, bits, group, epilogue, shift)
    lut_gemm.shapes[key] = lut_gemm.shapes.get(key, 0) + 1
    return out if a.dim() == 3 else out[0]


#: kernel launches made by this op (plain-version calls do not count)
lut_gemm.launches = 0
#: (T, M, N, K, bits, group, epilogue, shift) -> launches at that shape
lut_gemm.shapes = {}
