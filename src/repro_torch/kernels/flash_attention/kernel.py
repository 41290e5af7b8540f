"""ctypes binding of the CUDA flash_attention kernel
(``csrc/flash_attention.cu``; the design note is at the top of that file).
Built at first call by :mod:`repro_torch.kernels._build`, never at
import."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim the kernel is instantiated for
MAX_D = 128


def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """q (B, S, HQ, D), k and v (B, Sk, KH, D) on one CUDA device, of one
    dtype (float32 or bfloat16), each with a contiguous last dim and
    strides that are multiples of 4 elements.  Returns (B, S, HQ, D) in
    q's dtype, contiguous."""
    B, S, HQ, D = q.shape
    _, Sk, KH, _ = k.shape
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k "
                        f"and v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D % 4 or D > MAX_D:
        raise ValueError(f"the flash_attention kernel takes D a multiple of "
                         f"4 up to {MAX_D}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention {name} needs a contiguous "
                             f"last dim and strides that are multiples of "
                             f"4, got {t.stride()}")
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"flash_attention {name} is not aligned to 4 "
                             f"elements")
    out = torch.empty((B, S, HQ, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), DTYPES[q.dtype], B, HQ, KH, S, Sk, D,
                      ctypes.cast(strides, ctypes.c_void_p), int(causal),
                      float(1.0 / (D ** 0.5)), stream)
    _build.check(err, "flash_attention")
    return out
