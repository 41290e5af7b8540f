"""ctypes binding of the CUDA vta_gemm kernel (``csrc/vta_gemm.cu``; the
design note is at the top of that file).  Built at first call by
:mod:`repro_torch.kernels._build`, never at import."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

EPILOGUES = {"none": 0, "requant": 1, "dequant": 2}
OUT_DTYPES = {"none": torch.int32, "requant": torch.int8,
              "dequant": torch.float32}


def _launcher():
    fn = _build.load("vta_gemm").vta_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def vta_gemm_cuda(a: torch.Tensor, w_nk: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  scale: Optional[torch.Tensor],
                  epilogue: str, shift: int) -> torch.Tensor:
    """One launch over T tiles: a (T, M, K) int8, w_nk (T, N, K) int8 (W
    transposed, K contiguous), bias (N,) int32, scale (N,) float32, all
    contiguous on one CUDA device.  Returns (T, M, N)."""
    T, M, K = a.shape
    N = w_nk.shape[1]
    out = torch.empty((T, M, N), dtype=OUT_DTYPES[epilogue], device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _launcher()(a.data_ptr(), w_nk.data_ptr(),
                      bias.data_ptr() if bias is not None else None,
                      scale.data_ptr() if scale is not None else None,
                      out.data_ptr(), T, M, N, K, EPILOGUES[epilogue],
                      int(shift), stream)
    _build.check(err, "vta_gemm")
    return out
