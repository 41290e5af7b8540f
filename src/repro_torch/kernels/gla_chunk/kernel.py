"""ctypes binding of the CUDA gla_chunk kernel (``csrc/gla_chunk.cu``; the
design note is at the top of that file).  Built at first call by
:mod:`repro_torch.kernels._build`, never at import."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest state width N the kernel is instantiated for
MAX_N = 64
#: the most rows of a tile: a longer chunk is walked in tiles of this many
MAX_TILE = 64


def _launcher():
    fn = _build.load("gla_chunk").gla_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(name: str, t: torch.Tensor, dims) -> None:
    if t.stride(-1) != 1 or any(t.stride(d) % 4 for d in dims) \
            or t.data_ptr() % (4 * t.element_size()):
        raise ValueError(f"gla_chunk {name} needs a contiguous last dim, "
                         f"strides that are multiples of 4 and a start "
                         f"aligned to 4 elements, got strides {t.stride()}")


def gla_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   la: torch.Tensor, h0: Optional[torch.Tensor], tile: int,
                   y_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k (B, S, H, N) float32 or bfloat16 of one dtype, v (B, S, H, P)
    and la (B, S, H) float32, h0 (B, H, N, P) float32 or None (zeros), all
    on one CUDA device; q and k may be stride-0 views over heads.  The scan
    runs in tiles of `tile` rows (1..64).  Returns y (B, S, H, P) in
    `y_dtype` (float32 or bfloat16) and h (B, H, N, P) float32, both
    contiguous."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    if q.dtype not in DTYPES or k.dtype != q.dtype:
        raise TypeError(f"gla_chunk takes float32 or bfloat16 q and k of one "
                        f"dtype, got {q.dtype}, {k.dtype}")
    if v.dtype != torch.float32 or la.dtype != torch.float32 \
            or (h0 is not None and h0.dtype != torch.float32):
        raise TypeError(f"gla_chunk takes float32 v, la and h0, got "
                        f"{v.dtype}, {la.dtype}, "
                        f"{None if h0 is None else h0.dtype}")
    if y_dtype not in DTYPES:
        raise TypeError(f"gla_chunk writes y in float32 or bfloat16, not "
                        f"{y_dtype}")
    if N % 4 or not 4 <= N <= MAX_N:
        raise ValueError(f"the gla_chunk kernel takes N a multiple of 4 up "
                         f"to {MAX_N}, got {N}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"the gla_chunk kernel takes tiles of 1 to "
                         f"{MAX_TILE} rows, got {tile}")
    _aligned("q", q, (0, 1, 2))
    _aligned("k", k, (0, 1, 2))
    y = torch.empty((B, S, H, P), dtype=y_dtype, device=q.device)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=q.device)
    if B * H * P == 0:             # y and h are empty: nothing to compute
        return y, h
    if S == 0:
        raise ValueError("the gla_chunk kernel takes S > 0")
    h0_strides = h0.stride() if h0 is not None else (0, 0, 0, 0)
    strides = (ctypes.c_longlong * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride(), *la.stride(),
        *h0_strides, *y.stride())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      la.data_ptr(), 0 if h0 is None else h0.data_ptr(),
                      y.data_ptr(), h.data_ptr(), DTYPES[q.dtype],
                      DTYPES[y_dtype], B, H, S, N, P, tile,
                      ctypes.cast(strides, ctypes.c_void_p), stream)
    _build.check(err, "gla_chunk")
    return y, h
