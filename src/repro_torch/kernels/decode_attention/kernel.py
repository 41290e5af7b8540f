"""ctypes binding of the CUDA decode_attention kernels
(``csrc/decode_attention.cu``; the design note is at the top of that
file).  Built at first call by :mod:`repro_torch.kernels._build`, never at
import."""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from .. import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: KV positions per split: the split count is ceil(S / SPLIT), fixed by S
SPLIT = 256


def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 \
        + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lanes_per_row(D: int, vec: int) -> int:
    n = D // vec
    lpr = 1
    while lpr < n:
        lpr *= 2
    return lpr


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q (B*KH, G, D) contiguous; k, v (B, S, KH, D) views with the same
    strides and a contiguous last dim; kv_len an int or a one-element
    int32 tensor on the same CUDA device (read there: no host sync).  q
    may be of another dtype than k and v (it is upcast exactly in the
    kernel).  Returns (B*KH, G, D) in q's dtype."""
    BH, G, D = q.shape
    B, S, KH, _ = k.shape
    if q.dtype not in DTYPES or k.dtype not in DTYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q, and "
                        f"k and v of one such dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    vec = 16 // k.element_size()
    if D % vec or D > 32 * vec:
        raise ValueError(f"the decode_attention kernel takes D a multiple "
                         f"of {vec} up to {32 * vec} for {k.dtype}, got {D}")
    if k.stride() != v.stride() or k.stride(-1) != 1 \
            or any(s % vec for s in k.stride()[:3]):
        raise ValueError(f"k and v need equal strides, a contiguous last "
                         f"dim and 16-byte rows, got {k.stride()}, "
                         f"{v.stride()}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention operands must be 16-byte aligned")
    dev = q.device
    len_dev, len_host = None, 0
    if isinstance(kv_len, torch.Tensor):
        if kv_len.device != dev or kv_len.dtype != torch.int32 \
                or kv_len.numel() != 1:
            raise ValueError("a tensor kv_len must be one int32 on q's "
                             "device")
        len_dev = kv_len.contiguous().data_ptr()
    else:
        len_host = int(kv_len)
    splits = max(1, -(-S // SPLIT))
    ws = torch.empty(BH * splits * G * (D + 2), dtype=torch.float32,
                     device=dev)
    out = torch.empty((BH, G, D), dtype=q.dtype, device=dev)
    sb, ss, sh, _ = k.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), len_dev,
                      len_host, ws.data_ptr(), out.data_ptr(),
                      DTYPES[k.dtype], DTYPES[q.dtype], BH, KH, G, D, S,
                      SPLIT, splits,
                      _lanes_per_row(D, vec), sb, ss, sh,
                      float(1.0 / (D ** 0.5)), stream)
    _build.check(err, "decode_attention")
    return out
