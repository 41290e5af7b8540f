"""ctypes binding of the CUDA lut_gemm kernel (``csrc/lut_gemm.cu``; the
design note is at the top of that file).  Built at first call by
:mod:`repro_torch.kernels._build`, never at import."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

EPILOGUES = {"none": 0, "requant": 1}
OUT_DTYPES = {"none": torch.int32, "requant": torch.int8}
#: group sizes the kernel is instantiated for
GROUPS = (2, 4, 8)


def _launcher():
    fn = _build.load("lut_gemm").lut_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lut_gemm_cuda(a: torch.Tensor, w_nk: torch.Tensor, *, bits: int,
                  group: int, epilogue: str, shift: int) -> torch.Tensor:
    """One launch over T tiles: a (T, M, K) int8, w_nk (T, N, K) int8 (W
    transposed, K contiguous), both contiguous on one CUDA device.
    Returns (T, M, N)."""
    T, M, K = a.shape
    N = w_nk.shape[1]
    out = torch.empty((T, M, N), dtype=OUT_DTYPES[epilogue], device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _launcher()(a.data_ptr(), w_nk.data_ptr(), out.data_ptr(), T, M,
                      N, K, bits, group, EPILOGUES[epilogue], int(shift),
                      stream)
    _build.check(err, "lut_gemm")
    return out
